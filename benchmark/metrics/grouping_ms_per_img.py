"""Self milliseconds per line of the program's ``sd.strokes.grouping``
spans: the rest of each image's partition plan (the interval grouping, the
label map, the crop coordinates), then each chunk's group-id stack and its
packing (``pack_gid``)."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.strokes.grouping")
