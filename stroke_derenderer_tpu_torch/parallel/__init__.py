"""Execution policies across stages and devices. ``TwoStagePipeline``
(:mod:`.two_stage`) overlaps binarization with stroke decoding; the mesh
and multi-host policies of the JAX package's ``parallel`` are not ported
yet (ROADMAP.md item 13)."""


def __getattr__(name):  # lazy: two_stage pulls in both pipelines
    if name == "TwoStagePipeline":
        from stroke_derenderer_tpu_torch.parallel.two_stage import (
            TwoStagePipeline,
        )
        return TwoStagePipeline
    raise AttributeError(name)
