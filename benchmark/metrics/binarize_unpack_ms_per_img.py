"""Self milliseconds per line of the program's ``sd.binarize.unpack``
spans: the host work after the download (unpacking the bits, the host
stitch, the scaling to 0/255 and each image's slice)."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.binarize.unpack")
