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

Over a mesh (pipelines built with ``mesh=``, every rank running this same
code), the mesh splits along dp as the JAX package splits it: stage A on
the first half of the dp rows, stage B on the rest, each tp group whole.
Stage A's ranks binarize and its first rank sends each chunk's host masks
to stage B's ranks over gloo; stage B's ranks decode them; at the end
stage B's first rank shares the strokes, so that every rank returns the
whole result. A mesh with dp = 1 is shared by both stages, each stage on
its own thread with process groups of its own.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch
import torch.distributed as dist


class TwoStagePipeline:
    def __init__(self, binarizer, estimator, devices=None):
        """``devices``: ``torch.device``s (or names) for the two stages,
        default every card when the binarizer is on a card, else its
        device; on one device both stages share it. Pipelines that carry a
        mesh are split over it instead (collective: every rank of the mesh
        builds the pipeline); each stage's pipeline holds its half of the
        mesh only while the stage runs, and its own mesh again after."""
        self.binarizer = binarizer
        self.estimator = estimator
        self.mesh = binarizer.mesh if binarizer.mesh is not None \
            else estimator.mesh
        self._split = False
        self._meshes = {}
        if self.mesh is not None:
            mesh_a, mesh_b = self.mesh.split()
            self._meshes = {"a": mesh_a, "b": mesh_b}
            self._split = self.mesh.shape["dp"] >= 2
            self._a0 = int(mesh_a.ranks.ravel()[0])
            self._b0 = int(mesh_b.ranks.ravel()[0])
            self._b_ranks = [int(r) for r in mesh_b.ranks.ravel()]
            self._in_a = mesh_a.rank is not None
            devices = [self.mesh.device]
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

    @contextlib.contextmanager
    def _on(self, stage: str):
        """The device, stream and sub-mesh of ``stage`` ("a" or "b")."""
        with contextlib.ExitStack() as stack:
            if stage in self._meshes:
                pipe = self.binarizer if stage == "a" else self.estimator
                stack.callback(setattr, pipe, "mesh", pipe.mesh)
                pipe.mesh = self._meshes[stage]
            if stage in self._streams:
                stack.enter_context(torch.cuda.device(
                    self.dev_a if stage == "a" else self.dev_b))
                stack.enter_context(torch.cuda.stream(self._streams[stage]))
            yield

    def _run_split(self, produce, consume) -> None:
        """:meth:`_run` over the two halves of a mesh: stage A's ranks
        produce, its first rank sending each item (and at the end None) to
        stage B's ranks over gloo; stage B's ranks consume what they
        receive."""
        group = self.mesh._group("host")
        if self._in_a:
            def put(item) -> bool:
                if dist.get_rank() == self._a0:
                    for r in self._b_ranks:
                        dist.send_object_list([item], dst=r, group=group)
                return True
            try:
                with self._on("a"):
                    produce(put, threading.Event())
            finally:
                put(None)
            return
        with self._on("b"):
            while True:
                box = [None]
                dist.recv_object_list(box, src=self._a0, group=group)
                if box[0] is None:
                    return
                consume(box[0])

    def _run(self, produce, consume, maxsize: int):
        """``produce(put, stop)`` on a stage-A thread, feeding
        ``consume(item)`` on this thread through a queue of ``maxsize``
        (``stop`` is set once the consumer has stopped). The producer's put
        gives up once the consumer has stopped, so it never blocks on a
        full queue; the end-of-stream sentinel is delivered, not dropped;
        the first error of either side is raised here. Over a split mesh:
        :meth:`_run_split`."""
        if self._split:
            return self._run_split(produce, consume)
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
            masks[i] = mask
            strokes[i] = self.estimator.process_image(mask,
                                                      max_length=max_length)

        self._run(produce, consume, maxsize=2)
        return masks, self._shared(strokes)

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
            for i, m, s in zip(idx, chunk_masks, self.estimator.process_images(
                    chunk_masks, max_length=max_length)):
                masks[i], strokes[i] = m, s

        self._run(produce, consume, maxsize=1)
        return masks, self._shared(strokes)

    def _shared(self, strokes: list) -> list:
        """Over a split mesh, stage B's strokes on every rank (stage A's
        ranks have none of their own)."""
        if not self._split:
            return strokes
        box = [strokes]
        dist.broadcast_object_list(box, src=self._b0,
                                   group=self.mesh._group("host"))
        return box[0]
