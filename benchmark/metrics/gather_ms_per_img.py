"""Self milliseconds per line of the program's ``sd.strokes.gather`` spans:
the upload of the packed group-id images and the glyph rows' plans, and
the enqueue of the crop gather."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.strokes.gather")
