"""Self milliseconds per line of the program's ``sd.strokes.encode.vit``
spans: the host's launch of the ViT's patch embedding and blocks, inside
``sd.strokes.encode``."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.strokes.encode.vit")
