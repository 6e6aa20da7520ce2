"""Self milliseconds per line of the program's ``sd.strokes.polylines``
spans: each image's tokens to sorted polylines (``process_tokens``)."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.strokes.polylines")
