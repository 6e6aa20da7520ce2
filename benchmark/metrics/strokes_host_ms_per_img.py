"""Milliseconds per line of the strokes calls in which the card did nothing:
their wall time less the card's busy time inside them. The host geometry
(components, grouping, the partition plan and its upload, tokens to
polylines) and the launches' host side."""


def read(run):
    if not run.lines:
        return None
    return (run.span_s("strokes") - run.busy_in("strokes")) * 1e3 / run.lines
