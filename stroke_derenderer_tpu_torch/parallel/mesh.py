"""The ('dp', 'tp') mesh over ``torch.distributed`` ranks, counterpart of
the JAX ``parallel/mesh.py``.

The model code is SPMD: every rank runs the same host code on the same
inputs, takes its own rows (dp) and, where a layout says so, its own
columns (tp), and meets the other ranks in the collectives of
:class:`Mesh`. The layout rules are the JAX package's:

- tile and glyph batch axes on dp (inference and training);
- an NHWC tile batch's WIDTH on tp when tp divides it
  (:func:`tile_sharding`), else dp only; the UNet's 3x3 convolutions then
  take a one-column halo from their tp neighbours and GroupNorm sums its
  statistics over the tp group (``models/layers.py``);
- parameters by :func:`_spec_for_path` (conv kernels on their output
  channels, the embedding on the vocabulary, the head and ``enc_att``
  column-parallel), replicated where tp does not divide the axis.

Ranks are laid out row-major, rank = dp_index * tp + tp_index, as
``make_mesh`` reshapes the JAX device list. While a pipeline runs a network
under :func:`spmd`, ``ops/quant.py`` takes each int8 activation scale as
the max over the mesh and the layers read the width sharding.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.distributed as dist

from stroke_derenderer_tpu_torch.parallel import multihost
from stroke_derenderer_tpu_torch.utils.profiling import LEDGER


class Mesh:
    """``dp x tp`` ranks of the process group (``ranks``, (dp, tp) global
    ranks), this process's place in it and the groups of its collectives:
    the whole mesh, this rank's dp group (the ranks of its tp index, one
    per dp index, in dp order) and its tp group (its dp index's ranks).
    Without a process group, a mesh of one rank runs alone and a larger
    one only describes a layout (``rank`` None)."""

    def __init__(self, ranks: np.ndarray, device=None):
        self.ranks = np.asarray(ranks)
        dp, tp = self.ranks.shape
        self.shape = {"dp": int(dp), "tp": int(tp)}
        self.size = int(dp * tp)
        self.device = torch.device(device) if device is not None \
            else multihost.device()
        me = dist.get_rank() if dist.is_initialized() else (
            0 if self.size == 1 else None)
        where = np.argwhere(self.ranks == me) if me is not None else []
        self.rank = me if len(where) else None
        self.dp_index, self.tp_index = ((int(where[0][0]), int(where[0][1]))
                                        if len(where) else (None, None))
        self._groups: dict = {}  # by axis, made by _make_groups
        self._cpu_comm = (not dist.is_initialized()
                          or dist.get_backend() == "gloo")

    def __repr__(self):
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"rank={self.rank}, device={self.device})")

    # ---------------------------------------------------------- groups
    def _make_groups(self) -> None:
        """Create every group of this mesh. Collective over the WORLD: every
        rank of the process group calls it, in the same order."""
        if not dist.is_initialized() or self.size == 1:
            return
        new = lambda ranks, **kw: dist.new_group([int(r) for r in ranks],
                                                 **kw)
        g = {"all": new(self.ranks.ravel())}
        for c in range(self.shape["tp"]):
            grp = new(self.ranks[:, c])
            if c == self.tp_index:
                g["dp"] = grp
        for d in range(self.shape["dp"]):
            grp = new(self.ranks[d, :])
            if d == self.dp_index:
                g["tp"] = grp
        # Groups for host objects (pickled over gloo): the whole mesh, and
        # each tp group.
        g["host"], g["tp_host"] = g["all"], g.get("tp")
        if not self._cpu_comm:
            g["host"] = new(self.ranks.ravel(), backend="gloo")
            for d in range(self.shape["dp"]):
                grp = new(self.ranks[d, :], backend="gloo")
                if d == self.dp_index:
                    g["tp_host"] = grp
        self._groups = g

    def axis_size(self, axis: str) -> int:
        return {"all": self.size, "dp": self.shape["dp"],
                "tp": self.shape["tp"], "host": self.size,
                "tp_host": self.shape["tp"]}[axis]

    def _group(self, axis: str):
        if self.rank is None:
            raise RuntimeError(f"{self!r}: this process is not a rank of the "
                               "mesh (no process group, or another mesh)")
        return self._groups.get(axis)

    def _hops(self, t: torch.Tensor) -> bool:
        """Whether a collective on ``t`` goes through host memory from a
        card (gloo on a card): its copies down and up are then transfer
        hops of this rank, counted in ``LEDGER``."""
        return self._cpu_comm and t.device.type != "cpu"

    def _collective(self, t: torch.Tensor, axis: str, op) -> torch.Tensor:
        """``op(tensor, group)`` on a copy of ``t`` that the backend takes
        (on the host for gloo), returned on ``t``'s device."""
        group = self._group(axis)
        x = t.detach()
        x = x.cpu().clone() if self._cpu_comm else x.clone().contiguous()
        if self._hops(t):
            LEDGER.add_down(x)
        op(x, group)
        if self._hops(t):
            LEDGER.add_up(x)
        return x.to(t.device)

    # ---------------------------------------------------------- collectives
    def all_max(self, t: torch.Tensor, axis: str = "all") -> torch.Tensor:
        """Elementwise max of ``t`` over the ranks of ``axis``."""
        if self.axis_size(axis) == 1:
            return t
        return self._collective(t.float(), axis, lambda x, g: dist.all_reduce(
            x, dist.ReduceOp.MAX, group=g)).to(t.dtype)

    def all_sum(self, t: torch.Tensor, axis: str = "all") -> torch.Tensor:
        """Elementwise sum of ``t`` over the ranks of ``axis`` (a bfloat16
        ``t`` summed in float32 and rounded once)."""
        if self.axis_size(axis) == 1:
            return t
        wide = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        return self._collective(t.to(wide), axis, lambda x, g: dist.all_reduce(
            x, dist.ReduceOp.SUM, group=g)).to(t.dtype)

    def all_gather(self, t: torch.Tensor, axis: str = "dp",
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (all of one shape) of ``axis``, concatenated
        along ``dim`` in the axis's order (dp or tp index)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        # Exact widenings of the types gloo does not gather.
        wide = {torch.bfloat16: torch.float32, torch.bool: torch.uint8,
                torch.int16: torch.int32}.get(t.dtype, t.dtype)
        x = t.detach().to(wide).contiguous()
        if self._cpu_comm:
            x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group(axis))
        out = torch.cat(parts, dim=dim)
        if self._hops(t):
            LEDGER.add_down(x)
            LEDGER.add_up(out)
        return out.to(t.device, t.dtype)

    def halo(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        """NCHW ``x``, this rank's columns of a width split over tp ->
        ``x`` with ``pad`` columns of each tp neighbour on either side
        (zeros at the tile's true edges, as zero padding gives them)."""
        if pad == 0:
            return x
        zeros = x.new_zeros(x.shape[:-1] + (pad,))
        if self.shape["tp"] == 1:
            return torch.cat([zeros, x, zeros], dim=-1)
        edges = torch.stack([x[..., :pad], x[..., -pad:]])
        everyone = self.all_gather(edges[None], "tp", dim=0)
        c, tp = self.tp_index, self.shape["tp"]
        left = everyone[c - 1, 1] if c > 0 else zeros
        right = everyone[c + 1, 0] if c < tp - 1 else zeros
        return torch.cat([left, x, right], dim=-1)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self._group("host"))

    def broadcast_object(self, obj, axis: str = "host"):
        """``obj`` of the first rank of ``axis`` ("host": the mesh, in rank
        order; "tp_host": this rank's tp group) on every rank of it,
        pickled over gloo."""
        if self.axis_size(axis) == 1:
            return obj
        first = (self.ranks.ravel()[0] if axis == "host"
                 else self.ranks[self.dp_index, 0])
        box = [obj]
        dist.broadcast_object_list(box, src=int(first),
                                   group=self._group(axis))
        return box[0]

    # ---------------------------------------------------------- layout
    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row batch sharded on dp."""
        dp = self.shape["dp"]
        if n % dp:
            raise ValueError(f"batch {n} not divisible by dp={dp}")
        k = n // dp
        return slice(self.dp_index * k, (self.dp_index + 1) * k)

    def split(self):
        """Two sub-meshes along dp (stage A the first half of the dp rows,
        stage B the rest, each tp group kept whole), each with groups of
        its own; a mesh with dp < 2 gives two meshes over all its ranks,
        again with groups of their own, so that the two stages' collectives
        never meet. Collective over the world."""
        dp = self.shape["dp"]
        halves = ((self.ranks[:dp // 2], self.ranks[dp // 2:]) if dp >= 2
                  else (self.ranks, self.ranks))
        out = []
        for ranks in halves:
            sub = Mesh(ranks, self.device)
            sub._make_groups()
            out.append(sub)
        return tuple(out)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int = 1) -> Mesh:
    """The ('dp', 'tp') mesh over the ranks of the process group (default:
    all of them; one without a group). Collective over the world: every
    rank builds it, in the same order as its other meshes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if dp is None:
        dp = n // tp
    if dp * tp != n:  # the JAX package's assert, kept under -O
        raise AssertionError(f"dp*tp ({dp}*{tp}) != n_devices ({n})")
    if dist.is_initialized() and n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}"
                         ": spawn one rank per device of the mesh")
    mesh = Mesh(np.arange(n).reshape(dp, tp))
    mesh._make_groups()
    return mesh


def tile_sharding(mesh: Mesh, ndim: int, width: int) -> tuple:
    """NHWC tile batches: batch on dp and, when the mesh has a tp extent
    that divides the tile width, the WIDTH on tp; otherwise dp only (the
    leading axis on dp, the rest replicated)."""
    tp = mesh.shape["tp"]
    if ndim == 4 and tp > 1 and width % tp == 0:
        return ("dp", None, "tp", None)
    return ("dp",) + (None,) * (ndim - 1)


# ------------------------------------------------ parameter partitioning

def _spec_for_path(path: str, leaf) -> tuple:
    """The tensor-parallel layout of a flax param path (the JAX package's
    heuristic)."""
    if np.ndim(leaf) == 4 and path.endswith("kernel"):   # (kh, kw, cin, cout)
        return (None, None, None, "tp")
    if "embedding" in path and np.ndim(leaf) == 2:       # (vocab, embed)
        return ("tp", None)
    if path.endswith(("fc/kernel", "enc_att/kernel")) and np.ndim(leaf) == 2:
        return (None, "tp")                               # column-parallel
    return ()


def _map_with_paths(fn, tree, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def param_partition_specs(params) -> dict:
    """The spec of every leaf of a flax params tree (nested dicts), as
    tuples: () replicated, else one entry per axis, "tp" or None."""
    return _map_with_paths(_spec_for_path, params)


def effective_spec(path: str, leaf, tp: int) -> tuple:
    """:func:`_spec_for_path`, replicated when tp does not divide the axis
    it names (the JAX ``shard_params`` fallback). The vocabulary
    (3 + 2 x image_size) is odd, so at any even tp the embedding and the
    head stay replicated."""
    spec = _spec_for_path(path, leaf)
    for axis, name in enumerate(spec):
        if name == "tp" and np.shape(leaf)[axis] % tp:
            return ()
    return spec


def shard_params(params, mesh: Mesh) -> dict:
    """This rank's part of every leaf of a flax params tree (numpy), by
    :func:`effective_spec`: a "tp" axis cut into tp equal slices, the
    rank's tp index taking its own. The port shards kernels on their
    output axis only (conv kernels and the column-parallel ``enc_att``
    and head); a vocabulary-sharded embedding lookup raises."""
    tp = mesh.shape["tp"]

    def place(path, leaf):
        spec = effective_spec(path, leaf, tp) if tp > 1 else ()
        if not spec:
            return leaf
        axis = spec.index("tp")
        if axis != len(spec) - 1:
            raise NotImplementedError(
                f"{path}: the spec {spec} shards a leading axis; the port "
                "shards kernels on their output axis only")
        k = np.shape(leaf)[axis] // tp
        return np.take(np.asarray(leaf), range(mesh.tp_index * k,
                                              (mesh.tp_index + 1) * k),
                       axis=axis)

    return _map_with_paths(place, params)


class _CopyToTp(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the tp group (the
    input of a column-parallel layer feeds every rank's columns)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_sum(grad.contiguous(), "tp"), None


class _GatherFromTp(torch.autograd.Function):
    """Forward gathers the tp ranks' columns along ``dim``; backward keeps
    this rank's slice of the gradient. Every tp rank computes the same loss
    from the gathered tensor, so the slice is the whole gradient of its
    columns (a gather whose backward summed over tp would give tp times
    it)."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, y.shape[dim]
        return mesh.all_gather(y, "tp", dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.tp_index * ctx.n
        return grad.narrow(ctx.dim, start, ctx.n).contiguous(), None, None


def column_parallel(fn, x, mesh, dim: int):
    """``fn(x)`` with ``fn`` holding this rank's output columns of a
    column-parallel layer: its outputs gathered along ``dim`` over tp."""
    return _GatherFromTp.apply(fn(_CopyToTp.apply(x, mesh)), mesh, dim)


def shard_columns(module, mesh) -> dict:
    """Lay ``module``'s kernels out column-parallel on the mesh's tp group,
    as :func:`effective_spec` lays out the flax tree: every conv's kernel
    (``Conv2d``, and ``ConvTranspose2d`` whose outputs are its second
    axis) and the decoder's ``enc_att_w`` keep this rank's slice of their
    output axis where tp divides it, and their layers gather the outputs
    (``models/layers.conv``, ``AttentiveDecoder.forward``). The embedding
    and the head (vocabulary 3 + 2 x image_size, odd) stay replicated; a
    vocabulary tp divides would shard the embedding's lookup, which the
    port does not do, and raises. Returns {parameter name: (axis, whole
    size)} of the sharded parameters. Call before the optimizer is made."""
    from torch import nn
    tp, k = mesh.shape["tp"], mesh.tp_index
    sharded = {}
    if tp == 1:
        return sharded

    def cut(mod, attr, axis, name):
        p = getattr(mod, attr)
        n = p.shape[axis]
        if n % tp:
            return
        setattr(mod, attr, nn.Parameter(
            p.detach().narrow(axis, k * (n // tp), n // tp).clone(),
            requires_grad=p.requires_grad))
        mod.tp_mesh = mesh
        sharded[f"{name}.{attr}" if name else attr] = (axis, n)

    for name, mod in module.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            cut(mod, "weight", int(isinstance(mod, nn.ConvTranspose2d)),
                name)
        elif hasattr(mod, "enc_att_w") and hasattr(mod, "emb"):
            if mod.emb.shape[0] % tp == 0:
                raise NotImplementedError(
                    f"tp={tp} divides the vocabulary ({mod.emb.shape[0]}): "
                    "a vocabulary-sharded embedding lookup is not ported")
            cut(mod, "enc_att_w", 1, name)
    return sharded


def padded_batch(n: int, bucket: int, dp: int) -> int:
    """``n`` rounded up to a multiple of lcm(bucket, dp), as the JAX
    pipelines pad a batch they shard."""
    m = math.lcm(max(bucket, 1), max(dp, 1))
    return -(-n // m) * m


# ------------------------------------------------ the SPMD context

class _Spmd:
    def __init__(self, mesh: Mesh, width: bool):
        self.mesh = mesh
        self.width = width


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("spmd",
                                                         default=None)


@contextlib.contextmanager
def spmd(mesh: Mesh | None, width: bool = False):
    """Run a network's forward as this rank's part of the mesh: int8
    activation scales become the max over the whole mesh (replicas do not
    change a max) and, with ``width``, the tensors hold this rank's
    columns of a width split over tp. ``mesh`` None: no change. Per
    thread, so two pipelines on two threads keep their own."""
    if mesh is None or mesh.size == 1:
        yield
        return
    token = _ACTIVE.set(_Spmd(mesh, width))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> _Spmd | None:
    """The :func:`spmd` context of this thread, or None."""
    return _ACTIVE.get()
