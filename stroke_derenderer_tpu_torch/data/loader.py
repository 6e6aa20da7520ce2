"""Background-prefetch data loading, counterpart of the JAX
``data/loader.py``.

Sample generation (``data/synthetic.py``) is host CPU work that should
overlap the device's steps. :class:`PrefetchLoader` runs ``num_workers``
threads, each with its own iterator from the factory, feeding one bounded
queue. With more than one worker the order of batches depends on the
threads' timing; with one it is the iterator's own.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class _WorkerError:
    """Queue envelope carrying a worker thread's exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Pulls batches from ``make_iterator(worker_id)`` on ``num_workers``
    threads. A worker's exception is raised to the consumer."""

    def __init__(self, make_iterator: Callable[[int], Iterator],
                 num_workers: int = 2, prefetch: int = 4):
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = []
        for w in range(max(num_workers, 1)):
            t = threading.Thread(target=self._worker,
                                 args=(make_iterator, w), daemon=True)
            t.start()
            self._threads.append(t)

    def _put(self, item) -> bool:
        """Queue ``item`` unless the loader is closed first."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self, make_iterator, worker_id: int):
        try:
            for batch in make_iterator(worker_id):
                if not self._put(batch):
                    return
        except BaseException as e:  # carried to the consumer
            self._put(_WorkerError(e))
        finally:
            self._put(None)

    def __iter__(self):
        finished = 0
        while finished < len(self._threads):
            item = self._queue.get()
            if item is None:
                finished += 1
                continue
            if isinstance(item, _WorkerError):
                # A silently dead worker would end the iteration early and
                # the run would "finish" having taken few or no steps.
                raise RuntimeError("PrefetchLoader worker failed") from item.exc
            yield item

    def close(self):
        """Stop the workers: each finishes the batch it is making and exits
        without queueing it."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
