"""Self milliseconds per line of the program's ``sd.binarize.launch``
spans: the upload and the enqueue of the tile cut, UNet, stitch and pack
(fused path), or the bucketed tile batch up to its download."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.binarize.launch")
