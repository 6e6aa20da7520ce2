#!/usr/bin/env python3
"""Replay a pytest junit file through pytest-xdist's ``--dist loadfile``
scheduler, to see which files set the wall time of a parallel test run.

    python3 scripts/tier1_schedule.py JUNIT_XML [--workers 6] [--first FILE]

xdist's loadfile scheduling (``--loadscope-reorder``, on by default) queues
the test files by their number of tests, most first; every worker takes one
file at the start, then a second, and another whenever at most two of its
tests are left. This script replays that with each test's seconds from the
junit file (collection and start-up not counted) and prints the seconds of
each file, then the simulated wall time; with ``--first FILE`` (a module
name such as ``test_torch_smoke``) also the wall time with that file handed
out first.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def per_file(junit: str) -> dict[str, list[float]]:
    """Test seconds per test module, in collection order."""
    files: dict[str, list[float]] = {}
    for case in ET.parse(junit).iter("testcase"):
        name = case.get("classname", "").split(".")[-1]
        files.setdefault(name, []).append(float(case.get("time", 0)))
    return dict(sorted(files.items()))


def wall(files: dict[str, list[float]], workers: int,
         first: str | None = None) -> float:
    queue = collections.deque(sorted(files.items(),
                                     key=lambda kv: -len(kv[1])))
    if first is not None:
        queue.remove((first, files[first]))
        queue.appendleft((first, files[first]))
    pending = [collections.deque() for _ in range(workers)]

    def assign(w):
        if queue:
            pending[w].extend(queue.popleft()[1])

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    events = [(pending[w][0], w) for w in range(workers) if pending[w]]
    heapq.heapify(events)
    end = 0.0
    while events:
        t, w = heapq.heappop(events)
        pending[w].popleft()
        end = t
        if len(pending[w]) <= 2:
            assign(w)
        if pending[w]:
            heapq.heappush(events, (t + pending[w][0], w))
    return end


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("junit")
    parser.add_argument("--workers", type=int, default=6)
    parser.add_argument("--first", default=None)
    args = parser.parse_args()
    files = per_file(args.junit)
    for name, secs in sorted(files.items(), key=lambda kv: -sum(kv[1])):
        print(f"{sum(secs):8.1f} s {len(secs):4d} tests  {name}")
    total = sum(sum(v) for v in files.values())
    print(f"test seconds {total:.0f}, over {args.workers} workers "
          f"{total / args.workers:.0f}")
    print(f"simulated wall {wall(files, args.workers):.0f} s")
    if args.first:
        print(f"simulated wall with {args.first} first "
              f"{wall(files, args.workers, args.first):.0f} s")


if __name__ == "__main__":
    main()
