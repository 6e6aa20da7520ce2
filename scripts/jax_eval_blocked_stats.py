#!/usr/bin/env python3
"""The JAX package's evaluator with flax's normalization statistics summed
in another float32 order: each group's sum and sum of squares as sums of
64-element blocks, then divided by the count (flax sums in XLA's own order).
The model, its weights and every other operation are unchanged, so this is
an equally valid rounding of the same computation.

    JAX_PLATFORMS=cpu python scripts/jax_eval_blocked_stats.py \
        --models models_demo --data examples/real_data --quant int8

Arguments are those of ``python -m stroke_derenderer_tpu.eval.run``. Under
int8 the result moves with such roundings: a flat background gives many
equal values, one bf16 rounding of them moves them all, and an int8 step
can follow (``scripts/jax_cpu_eval.py --quant int8`` records both orders).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
BLOCK = 64


def blocked_stats(x, axes, dtype, *args, **kwargs):
    """(mean, var) as flax's ``_compute_stats`` with its fast variance
    E[x^2] - E[x]^2 floored at 0, the sums taken block by block."""
    import jax.numpy as jnp
    from flax.linen import normalization
    x = jnp.asarray(x, jnp.promote_types(dtype or x.dtype, jnp.float32))
    axes = normalization._canonicalize_axes(x.ndim, axes)
    keep = [d for d in range(x.ndim) if d not in axes]
    rows = jnp.transpose(x, keep + list(axes))
    rows = rows.reshape(rows.shape[:len(keep)] + (-1,))
    n = rows.shape[-1]
    rows = jnp.pad(rows, [(0, 0)] * len(keep) + [(0, (-n) % BLOCK)])
    blocks = rows.reshape(rows.shape[:-1] + (-1, BLOCK))
    mean = blocks.sum(-1).sum(-1) / n
    mean2 = (blocks * blocks).sum(-1).sum(-1) / n
    return mean, jnp.maximum(0.0, mean2 - mean * mean)


def main(argv=None) -> int:
    from flax.linen import normalization
    normalization._compute_stats = blocked_stats
    from stroke_derenderer_tpu.eval.run import main as eval_main
    return eval_main(argv)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
