"""Execution policies across stages and devices, counterpart of the JAX
package's ``parallel``: the ('dp', 'tp') mesh over ``torch.distributed``
ranks (:mod:`.mesh`), the multi-process runtime that starts and joins the
ranks (:mod:`.multihost`), and ``TwoStagePipeline`` (:mod:`.two_stage`),
which overlaps binarization with stroke decoding."""

from stroke_derenderer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, param_partition_specs, shard_params, tile_sharding,
)


def __getattr__(name):  # lazy: two_stage pulls in both pipelines
    if name == "TwoStagePipeline":
        from stroke_derenderer_tpu_torch.parallel.two_stage import (
            TwoStagePipeline,
        )
        return TwoStagePipeline
    raise AttributeError(name)
