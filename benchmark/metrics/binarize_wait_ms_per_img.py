"""Self milliseconds per line of the program's ``sd.binarize.wait`` spans:
the blocking download of the masks or packed bits, the host waiting for
the card."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.binarize.wait")
