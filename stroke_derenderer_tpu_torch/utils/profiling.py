"""Tracing and profiling: the counterpart of the JAX ``utils/profiling.py``.

- :class:`StageTimer`: wall-clock seconds per named stage, with a summary
  table.
- :class:`TransferLedger` and the process-wide :data:`LEDGER`: bytes and
  events of every blocking host<->device hop, fed by the pipelines'
  transfer sites (one ``add_up`` or ``add_down`` per hop) and, on a card
  shared over gloo, by the mesh's collectives; each process (each rank)
  counts its own. :func:`upload` and :func:`download` are the pipelines'
  hops. Set-up copies (weights, the decode kernels' ownership plans, once
  per model) are not counted, as the JAX package counts none.
- :func:`device_trace`: a ``torch.profiler`` trace (CPU and, where there is
  a card, CUDA activities) written as a Chrome trace into a directory.
- :func:`chip_busy_ms`: the card's busy milliseconds in the newest such
  trace, the union of its kernel, memcpy and memset intervals.
- :func:`span` and the process-wide :data:`SPANS`: the program's named
  spans (``sd.<layer>[.<part>]``), which, while a ``torch.profiler``
  profile records (:func:`recording`), land in its trace as
  ``record_function`` ranges and in :data:`SPANS`; otherwise a span is a
  shared null context, one flag read.
- :class:`Counters` and the process-wide :data:`COUNTERS`: integers added
  by name at the same sites, only while a profile records. The first span
  or count of a new profile clears both, so that after a traced stretch
  they hold that stretch's spans and counts alone.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import itertools
import json
import threading
import time
import typing
from pathlib import Path

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


class StageTimer:
    """Accumulates wall-clock seconds per named stage.

    >>> timer = StageTimer()
    >>> with timer("forward"):
    ...     run()
    >>> timer.summary()
    """

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'stage':<16}{'total_s':>10}{'calls':>8}{'mean_ms':>10}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<16}{tot:>10.3f}{n:>8}"
                         f"{1000 * tot / n:>10.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"total_s": self.totals[k], "calls": self.counts[k]}
                for k in self.totals}


class TransferLedger:
    """Cumulative host->device ("up") and device->host ("down") bytes and
    events (one event per ``add_up``/``add_down`` call, one blocking hop).
    Arrays may be numpy arrays, tensors, None (skipped) or nested tuples
    and lists of them. Thread-safe: the two-stage pipeline's stages feed it
    from two threads."""

    def __init__(self):
        self.up = 0
        self.down = 0
        self.n_up = 0
        self.n_down = 0
        self._lock = threading.Lock()

    @staticmethod
    def _nbytes(arrays) -> int:
        n = 0
        for a in arrays:
            if a is None:
                continue
            if isinstance(a, (tuple, list)):  # e.g. RLE (starts, vals)
                n += TransferLedger._nbytes(a)
            elif isinstance(a, torch.Tensor):
                n += a.numel() * a.element_size()
            else:
                n += int(a.nbytes)
        return n

    def add_up(self, *arrays) -> None:
        n = self._nbytes(arrays)
        with self._lock:
            self.up += n
            self.n_up += 1

    def add_down(self, *arrays) -> None:
        n = self._nbytes(arrays)
        with self._lock:
            self.down += n
            self.n_down += 1

    def snapshot(self) -> tuple[int, int, int, int]:
        with self._lock:
            return (self.up, self.down, self.n_up, self.n_down)

    def delta(self, since) -> tuple[int, int, int, int]:
        """(up, down, n_up, n_down) since a :meth:`snapshot`."""
        now = self.snapshot()
        return tuple(a - b for a, b in zip(now, since))


LEDGER = TransferLedger()


def recording() -> bool:
    """Whether a ``torch.profiler`` profile is recording now (in this
    process): the module-level flag that ``torch.autograd.profiler`` sets
    while one is, read without a call into the profiler."""
    return _autograd_profiler._is_profiler_enabled


class SpanRecord(typing.NamedTuple):
    """One closed span: ``parent`` is the ``id`` of the span open around it
    on the same thread (None at the top), times are ``time.time()``
    seconds, the clock a ``torch.profiler`` trace counts from its base."""
    id: int
    parent: int | None
    name: str
    start: float
    end: float


class _Span:
    """One open span: a ``record_function`` range in the profile's trace,
    and a :class:`SpanRecord` in its log when it closes."""

    __slots__ = ("log", "name", "sid", "parent", "rf", "t0")

    def __init__(self, log: SpanLog, name: str):
        self.log, self.name = log, name

    def __enter__(self):
        stack = self.log._stack()
        self.sid = next(self.log._ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.sid)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        t1 = time.time()
        self.rf.__exit__(*exc)
        self.log._stack().pop()
        self.log._append(SpanRecord(self.sid, self.parent, self.name,
                                    self.t0, t1))
        return False


class SpanLog:
    """The spans closed while a profile recorded, in the order they closed.
    Thread-safe; each thread nests its own spans."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open = threading.local()
        self._ids = itertools.count()
        self._records: list[SpanRecord] = []

    def _stack(self) -> list[int]:
        return self._open.__dict__.setdefault("stack", [])

    def _append(self, record: SpanRecord) -> None:
        with self._lock:
            self._records.append(record)

    def open(self, name: str) -> _Span:
        """A span of ``name`` around a ``with`` block."""
        return _Span(self, name)

    def records(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


class Counters:
    """Integers added by name while a profile records, and counts deferred
    until the card has done the work they read (:meth:`defer`). Thread-safe
    like :class:`TransferLedger`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = collections.defaultdict(int)
        self._pending: list = []

    def add(self, name: str, n: int = 1) -> None:
        if _recording_now():
            with self._lock:
                self._counts[name] += int(n)

    def defer(self, counts, *args) -> None:
        """While a profile records, keep ``counts(*args)``, which returns
        {name: int} from tensors the card may still be writing (``args``,
        held until then: a decode's tokens); it is called at the next
        :meth:`snapshot`, after the profile, so the pipeline never waits
        for it and the trace holds none of its work. A new profile drops
        what was kept."""
        if _recording_now():
            with self._lock:
                self._pending.append((counts, args))

    def snapshot(self) -> dict[str, int]:
        """Every count so far, the deferred ones included."""
        with self._lock:
            pending, self._pending = self._pending, []
        done = [fn(*args) for fn, args in pending]
        with self._lock:
            for counts in done:
                for name, n in counts.items():
                    self._counts[name] += int(n)
            return dict(self._counts)

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self._pending.clear()


SPANS = SpanLog()
COUNTERS = Counters()
_NOT_RECORDING = contextlib.nullcontext()
_new_profile_lock = threading.Lock()
_idle_seen = True   # a span or count has seen no profile since the last clear


def _recording_now() -> bool:
    """:func:`recording`; the first span or count of a profile that follows
    one seen without it clears :data:`SPANS` and :data:`COUNTERS`, so they
    hold the spans and counts of the newest profile alone."""
    global _idle_seen
    if not recording():
        _idle_seen = True
        return False
    if _idle_seen:
        with _new_profile_lock:
            if _idle_seen:
                SPANS.clear()
                COUNTERS.clear()
                _idle_seen = False
    return True


def span(name: str):
    """The program's span ``name`` (``sd.`` and a dotted path of layers)
    around a block: while a profile records, :meth:`SpanLog.open` of
    :data:`SPANS`; otherwise a shared null context."""
    return SPANS.open(name) if _recording_now() else _NOT_RECORDING


def upload(device, *arrays) -> list[torch.Tensor]:
    """numpy arrays -> tensors on ``device``, in ONE host->device copy (one
    :data:`LEDGER` event): the arrays' bytes are laid end to end in one
    buffer, each at an 8-byte boundary, and viewed back on the device. The
    ledger counts the arrays' bytes, not the alignment padding."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, end = [], 0
    for a in arrays:
        offsets.append(end)
        end += -(-a.nbytes // 8) * 8
    buf = np.empty(end, np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    LEDGER.add_up(*arrays)
    dev = torch.from_numpy(buf).to(device)
    return [dev[o:o + a.nbytes].view(_torch_dtype(a.dtype)).reshape(a.shape)
            for a, o in zip(arrays, offsets)]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def download(t: torch.Tensor) -> np.ndarray:
    """A tensor -> its numpy array on the host, one :data:`LEDGER` event."""
    out = t.cpu().numpy()
    LEDGER.add_down(out)
    return out


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """Profile the block with ``torch.profiler`` and write the trace into
    ``log_dir`` as ``<ns>.pt.trace.json``, a Chrome trace that
    :func:`chip_busy_ms` reads. CPU activities always; CUDA activities
    when ``device`` (the device the traced work runs on; default: a card
    where one is present) is a card. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / f"{time.time_ns()}.pt.trace.json"))


# Chrome-trace categories of work on the card; host ("cpu_op",
# "cuda_runtime", "python_function", ...) and annotation tracks are not.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def chip_busy_ms(trace_dir) -> float | None:
    """Busy milliseconds of the card in the newest trace under
    ``trace_dir`` (``*.trace.json`` or ``*.trace.json.gz``): the measure of
    the union of its device intervals (``DEVICE_CATEGORIES``), nested and
    overlapping ones counted once. None when there is no trace or it holds
    no device interval."""
    traces = sorted((p for p in Path(trace_dir).rglob("*.trace.json*")
                     if p.name.endswith((".json", ".json.gz"))),
                    key=lambda p: p.stat().st_mtime)
    if not traces:
        return None
    opener = gzip.open if traces[-1].suffix == ".gz" else open
    with opener(traces[-1], "rt") as f:
        events = json.load(f).get("traceEvents", [])
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                for e in events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    if not iv:
        return None
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, t in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    return busy / 1e3  # trace timestamps are microseconds
