"""Self milliseconds per line of the program's ``sd.strokes.encode`` spans:
the enqueue of the normalization, the encoder and the projection."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.strokes.encode")
