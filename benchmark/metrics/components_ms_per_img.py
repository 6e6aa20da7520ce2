"""Self milliseconds per line of the program's ``sd.strokes.components``
spans: the connected components of each mask (``ops/connected``, native),
inside the partition plan."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.strokes.components")
