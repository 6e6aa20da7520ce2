"""Self milliseconds per line of the program's ``sd.binarize.prep`` spans:
the host work before the upload (the resize to the model's height, the
host tile cut, the stacking), fused and bucketed paths alike."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.binarize.prep")
