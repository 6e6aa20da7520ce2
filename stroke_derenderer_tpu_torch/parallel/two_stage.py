"""Two-stage overlap: the binarizer (stage A) and the stroke estimator
(stage B) on their own host threads, joined by a bounded queue, so that
stage A binarizes image (or chunk) k + 1 while stage B decodes k.
Counterpart of the JAX ``parallel/two_stage.py``.

Only host masks cross the queue, so no tensor crosses streams or devices.
On a card each stage issues its work on its own CUDA stream (K1 and K2
launch on the current stream), so the two stages' kernels may run side by
side; with ``devices`` of two or more cards, stage A lives on the first and
stage B on the one half-way along the list. The outputs are those of the
sequential run over the same images or chunks.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch


class TwoStagePipeline:
    def __init__(self, binarizer, estimator, devices=None):
        """``devices``: ``torch.device``s (or names) for the two stages,
        default every card when the binarizer is on a card, else its
        device; on one device both stages share it. A pipeline that
        carries a mesh (the JAX package's dp x tp split) is not ported."""
        if (getattr(binarizer, "mesh", None) is not None
                or getattr(estimator, "mesh", None) is not None):
            raise NotImplementedError(
                "two-stage over a mesh is not ported (ROADMAP.md item 13)")
        self.binarizer = binarizer
        self.estimator = estimator
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if binarizer.device.type == "cuda"
                       else [binarizer.device])
        devices = [torch.device(d) for d in devices]
        half = max(len(devices) // 2, 1)
        self.dev_a = devices[0]
        self.dev_b = devices[half % len(devices)]
        binarizer.model.to(self.dev_a)
        binarizer.device = self.dev_a
        for name in ("encoder", "decoder", "projection"):
            mod = getattr(estimator, name)
            if mod is not None:
                mod.to(self.dev_b)
        estimator.device = self.dev_b
        # A stream for each stage, on one card too; each waits for the
        # weights, which were written on the default stream.
        self._streams = {}
        for stage, dev in (("a", self.dev_a), ("b", self.dev_b)):
            if dev.type == "cuda":
                s = torch.cuda.Stream(device=dev)
                s.wait_stream(torch.cuda.current_stream(dev))
                self._streams[stage] = s

    def _on(self, stage: str):
        """The device and stream context of ``stage`` ("a" or "b")."""
        if stage not in self._streams:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(
            self.dev_a if stage == "a" else self.dev_b))
        stack.enter_context(torch.cuda.stream(self._streams[stage]))
        return stack

    def _run(self, produce, consume, maxsize: int):
        """``produce(put, stop)`` on a stage-A thread, feeding
        ``consume(item)`` on this thread through a queue of ``maxsize``
        (``stop`` is set once the consumer has stopped). The producer's put
        gives up once the consumer has stopped, so it never blocks on a
        full queue; the end-of-stream sentinel is delivered, not dropped;
        the first error of either side is raised here."""
        q: queue.Queue = queue.Queue(maxsize=maxsize)
        errors: list = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stage_a():
            try:
                with self._on("a"):
                    produce(put, stop)
            except Exception as exc:  # raised to the consumer below
                errors.append(exc)
            finally:
                put(None)

        t = threading.Thread(target=stage_a, daemon=True)
        t.start()
        try:
            with self._on("b"):
                while True:
                    item = q.get()
                    if item is None:
                        break
                    consume(item)
        finally:
            stop.set()
            while True:  # unblock a producer mid-put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
        if errors:
            raise errors[0]

    def process(self, images, max_length: int | None = None):
        """[(H, W, 3) uint8, ...] -> (masks, per-image stroke lists), image
        by image: ``binarize_image`` of image k + 1 beside
        ``process_image`` of image k."""
        masks: list = [None] * len(images)
        strokes: list = [None] * len(images)
        thr = 255 * self.binarizer.config.bin_thr

        def produce(put, stop):
            for i, img in enumerate(images):
                if stop.is_set():
                    return
                masks[i] = self.binarizer.binarize_image(
                    np.asarray(img))[:, :, 0] > thr
                if not put((i, masks[i])):
                    return

        def consume(item):
            i, mask = item
            strokes[i] = self.estimator.process_image(mask,
                                                      max_length=max_length)

        self._run(produce, consume, maxsize=2)
        return masks, strokes

    def process_batched(self, images, chunk_size: int = 8,
                        max_length: int | None = None):
        """Chunks of ``chunk_size`` images: ``binarize_images`` of chunk
        k + 1 beside ``process_images`` of chunk k. The outputs are those
        of the two calls on each chunk in turn; without int8 they are also
        those of any other chunking."""
        images = list(images)
        chunks = [range(s, min(s + chunk_size, len(images)))
                  for s in range(0, len(images), chunk_size)]
        masks: list = [None] * len(images)
        strokes: list = [None] * len(images)
        thr = 255 * self.binarizer.config.bin_thr

        def produce(put, stop):
            for idx in chunks:
                if stop.is_set():
                    return
                bins = self.binarizer.binarize_images(
                    [np.asarray(images[i]) for i in idx])
                chunk_masks = [b[:, :, 0] > thr for b in bins]
                for i, m in zip(idx, chunk_masks):
                    masks[i] = m
                if not put((idx, chunk_masks)):
                    return

        def consume(item):
            idx, chunk_masks = item
            for i, s in zip(idx, self.estimator.process_images(
                    chunk_masks, max_length=max_length)):
                strokes[i] = s

        self._run(produce, consume, maxsize=1)
        return masks, strokes
