"""Per cent of the card's idle time in the traced window at which no layer
span of the program is the innermost one open: idle time the program's
layers do not explain (the benchmark's own work between and around the
calls, and the program's outside its layers, under only ``sd.binarize``
or ``sd.strokes``)."""

from harness import program, trace


def read(run):
    recs = program.records()
    idle = run.window_s - run.busy_s
    if not recs or idle <= 0:
        return None
    off = program.trace_offset(run, recs)
    if off is None:
        return None
    lo, hi = run.window
    own = trace.union((max(s + off, lo), min(e + off, hi))
                      for s, e in program.layer_self_intervals(recs)
                      if e + off > lo and s + off < hi)
    explained = sum(e - s for s, e in own) - sum(
        trace.covered(own, s, e) for s, e in run.busy)
    return (idle - explained) / idle * 100.0
