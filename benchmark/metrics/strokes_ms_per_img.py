"""Host milliseconds per line inside the ``process_images`` calls, from the
benchmark's spans around them."""


def read(run):
    return run.span_s("strokes") * 1e3 / run.lines if run.lines else None
