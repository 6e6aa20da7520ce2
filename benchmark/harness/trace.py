"""Reduction of a ``torch.profiler`` Chrome trace of a stretch of calls.

The device's work is the union of its kernel, memcpy and memset
intervals (nested or overlapping ones counted once: a frozen copy of the
arithmetic of ``utils/profiling.chip_busy_ms``). The benchmark's own spans
are ``record_function`` annotations named ``bench.<name>``, on the same
clock. The traced window runs from the first call's start to the last
call's end.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged, lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` that the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


@dataclasses.dataclass
class Traced:
    """A traced stretch: times in seconds on the trace's clock."""
    window: tuple[float, float]
    spans: dict            # name -> [(start, end)]
    kernels: list          # [(start, end, name)] of device work in the window
    busy: list             # merged device intervals, clipped to the window
    calls: list            # per traced call: what the runner counted
    config: dict
    traffic: dict

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    @property
    def lines(self) -> int:
        return sum(c["lines"] for c in self.calls)

    def span_s(self, name: str) -> float:
        return sum(e - s for s, e in self.spans.get(name, []))

    def busy_in(self, name: str) -> float:
        return sum(covered(self.busy, s, e) for s, e in self.spans.get(name, []))

    def kernel_s(self, substring: str, within: str | None = None) -> float:
        """Device seconds of the kernels whose name holds ``substring``
        (inside the spans ``within`` where given)."""
        iv = [(s, e) for s, e, n in self.kernels if substring in n]
        if within is None:
            return sum(e - s for s, e in union(iv))
        merged = union(iv)
        return sum(covered(merged, s, e) for s, e in self.spans.get(within, []))

    def has_kernel(self, substring: str) -> bool:
        return any(substring in n for _, _, n in self.kernels)


def load(path: Path, calls: list, config: dict, traffic: dict) -> Traced:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans: dict = {}
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"]) * 1e-6
        t = s + float(e.get("dur", 0)) * 1e-6
        if e.get("cat") in DEVICE_CATEGORIES:
            dev.append((s, t, e.get("name", "")))
        elif e.get("cat") == "user_annotation" and e.get("name", "").startswith("bench."):
            spans.setdefault(e["name"][6:], []).append((s, t))
    calls_iv = sorted(spans.get("call", []))
    if not calls_iv:
        raise RuntimeError("the trace holds no bench.call span")
    lo, hi = calls_iv[0][0], calls_iv[-1][1]
    kernels = [(max(s, lo), min(t, hi), n) for s, t, n in dev if t > lo and s < hi]
    busy = union((s, t) for s, t, _ in kernels)
    return Traced((lo, hi), {k: sorted(v) for k, v in spans.items()},
                  kernels, busy, calls, config, traffic)


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its return type and argument list (its
    template arguments kept), at most ``limit`` characters."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0 and name[i - 1] not in ": ":
            name = name[:i]
            break
    return name[:limit]


def breakdown(run: Traced) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps of the device, each named by the benchmark span the host was
    in at the gap's middle."""
    by_name: dict = {}
    for s, e, n in run.kernels:
        n = short_name(n)
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edges = [run.window[0]] + [x for iv in run.busy for x in iv] + [run.window[1]]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = (s + e) / 2
            where = next((name for name in ("binarize", "strokes")
                          for a, b in run.spans.get(name, []) if a <= mid <= b),
                         "between calls")
            gaps.append((f"host in {where}", e - s))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
