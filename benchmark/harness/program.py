"""The program's own spans and counters over a traced stretch.

While a ``torch.profiler`` profile records, the program
(``stroke_derenderer_tpu_torch.utils.profiling``) keeps its ``sd.`` spans
in ``SPANS`` and adds its counts to ``COUNTERS``, in this process, and
clears both when a new profile starts; the spans also land in the trace as
``record_function`` ranges, which ``trace.load`` does not keep. The
readers here take both from the program. A span's self time is its
duration less what its child spans (the spans opened inside it on its
thread) cover. The program times its spans on the Unix clock, which the
trace counts from a base of its own; :func:`trace_offset` finds that base
from the benchmark's spans around the same calls. Against a program that
keeps neither, every reader gives None.
"""

from __future__ import annotations

import collections
import importlib
import statistics

from harness import trace

PROFILING = "stroke_derenderer_tpu_torch.utils.profiling"
# The program's outermost spans and the benchmark's spans around them.
OUTER = (("sd.binarize", "binarize"), ("sd.strokes", "strokes"))


def _profiling():
    try:
        return importlib.import_module(PROFILING)
    except ImportError:
        return None


def counters() -> dict | None:
    """The program's counts of the newest profile ({name: int}), None where
    it keeps none."""
    counts = getattr(_profiling(), "COUNTERS", None)
    return None if counts is None else counts.snapshot()


def records() -> list | None:
    """The program's spans closed in the newest profile (``SpanRecord``:
    id, parent, name, start, end), None where it keeps none."""
    log = getattr(_profiling(), "SPANS", None)
    return None if log is None else log.records()


def _children(recs) -> dict:
    kids = collections.defaultdict(list)
    for r in recs:
        if r.parent is not None:
            kids[r.parent].append((r.start, r.end))
    return kids


def self_times(recs) -> dict[str, float]:
    """Seconds by span name: each span's duration less its children's."""
    kids = _children(recs)
    out: dict = collections.defaultdict(float)
    for r in recs:
        out[r.name] += r.end - r.start - sum(e - s for s, e in kids[r.id])
    return dict(out)


def self_ms_per_img(run, name: str) -> float | None:
    """Self milliseconds of the program's spans ``name`` per traced line."""
    recs = records()
    if not recs or not run.lines:
        return None
    t = self_times(recs)
    return t[name] * 1e3 / run.lines if name in t else None


def layer_self_intervals(recs) -> list[tuple[float, float]]:
    """The instants at which a layer span is the innermost one open: each
    span inside another, less what its own children cover. The outermost
    spans' self time (``sd.binarize``, ``sd.strokes`` between their
    layers) is not among them."""
    kids = _children(recs)
    out = []
    for r in recs:
        if r.parent is None:
            continue
        t = r.start
        for s, e in trace.union(kids[r.id]):
            if s > t:
                out.append((t, min(s, r.end)))
            t = max(t, e)
        if r.end > t:
            out.append((t, r.end))
    return out


def trace_offset(run, recs) -> float | None:
    """Seconds to add to the program's times to put them on the trace's
    clock: the median, over the traced calls, of the shift that centres
    each outermost ``sd.binarize`` and ``sd.strokes`` in the benchmark's
    span around the same call (a few microseconds inside it at each end).
    None where the calls do not pair up."""
    pairs = []
    for prog, bench in OUTER:
        inner = sorted((r.start, r.end) for r in recs
                       if r.name == prog and r.parent is None)
        outer = run.spans.get(bench, [])
        if len(inner) != len(outer):
            return None
        pairs += zip(outer, inner)
    if not pairs:
        return None
    return statistics.median((b0 - p0 + b1 - p1) / 2
                             for (b0, b1), (p0, p1) in pairs)
