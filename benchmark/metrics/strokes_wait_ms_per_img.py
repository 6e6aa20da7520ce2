"""Self milliseconds per line of the program's ``sd.strokes.wait`` spans:
the blocking download of the tokens, the host waiting for the card."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.strokes.wait")
