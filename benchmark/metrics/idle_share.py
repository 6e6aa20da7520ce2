"""Per cent of the traced window in which the card ran no kernel, copy or
memset: 1 - (union of their intervals) / window."""


def read(run):
    return (1.0 - run.busy_s / run.window_s) * 100.0 if run.window_s > 0 else None
