"""Self milliseconds per line of the program's ``sd.strokes.decode`` spans:
the attention projection, the initial state, the packed weights and the
K1 or K2 launch, as enqueued by the host."""

from harness import program


def read(run):
    return program.self_ms_per_img(run, "sd.strokes.decode")
