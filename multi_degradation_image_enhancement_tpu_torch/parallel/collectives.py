"""Differentiable collectives over a mesh axis: what XLA's SPMD partitioner
inserts on the JAX side, written out for ``torch.distributed``.

The JAX package annotates shardings and lets XLA insert the gradient
all-reduce, the conv halo exchanges and the global BatchNorm reductions
(``parallel/mesh.py``).  Here they are explicit, and hold one invariant: a
sharded step is the single-device step on the global batch.  Each rank's
loss is its share of the global loss (the global loss is the sum of the
shares), so every reduction's backward is the adjoint of its forward: an
all-reduced value's gradient is the sum of the ranks' gradients of it, and
each rank keeps the part that belongs to its own input.

Every exchange is written on ``all_reduce`` and ``broadcast`` alone, the two
collectives that both ``nccl`` and ``gloo`` carry for CUDA tensors: a gather
is an all-reduce of a zero-filled buffer in which each rank fills its own
slot (exact: x + 0 = x).

The mesh a step runs under is set by :func:`use_mesh` (``parallel.mesh.
shard_train_step`` / ``shard_eval_step`` enter it); the model, the losses and
the optimizer read it through :func:`active_mesh`.  With no mesh, or a mesh
without a process group (one process), every helper here is the plain
single-device operation.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_ACTIVE = None  # the Mesh of the step being run, or None


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the body with ``mesh`` active (``None``: no mesh)."""
    global _ACTIVE
    outer, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = outer


def unsharded():
    """Run the body as one device would (per-image loss terms)."""
    return use_mesh(None)


def active_mesh():
    return _ACTIVE


def spatial_shards() -> int:
    """Ways the image height is split under the active mesh (1 without)."""
    return 1 if _ACTIVE is None else _ACTIVE.size("spatial")


def _group(axes: Sequence[str]):
    """The active mesh's process group over ``axes`` (None: nothing to do)."""
    return None if _ACTIVE is None else _ACTIVE.group_of(axes)


# --------------------------------------------------------------- reductions


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group's ranks, on every rank; the backward sums the ranks'
    gradients.  ``group`` None: ``x``."""
    return x if group is None else _AllReduceSum.apply(x, group)


class _AllReduceMax(torch.autograd.Function):
    """``x.amax(dims, keepdim=True)`` over the group: the gradient goes to the
    elements equal to the global maximum, split evenly among all of them on
    every rank (as JAX's ``max`` reduction splits it between ties)."""

    @staticmethod
    def forward(ctx, x, dims, group):
        m = x.detach().amax(dim=dims, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        eq = x.detach() == m
        n = eq.sum(dim=dims, keepdim=True).to(x.dtype)
        dist.all_reduce(n, group=group)
        ctx.save_for_backward(eq, n)
        ctx.group = group
        return m

    @staticmethod
    def backward(ctx, grad):
        eq, n = ctx.saved_tensors
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return eq * (g / n), None, None


def all_reduce_amax(x: torch.Tensor, dims: Tuple[int, ...], group) -> torch.Tensor:
    """``x.amax(dims)`` (``dims`` empty: over every element) across the
    group's ranks.  ``group`` None: the local ``amax``."""
    if group is None:
        return x.amax(dim=dims) if dims else x.amax()
    dims = tuple(d % x.dim() for d in dims) if dims else tuple(range(x.dim()))
    return _AllReduceMax.apply(x, dims, group).squeeze(dims)


def all_reduce_detached(t: torch.Tensor, group) -> torch.Tensor:
    """A summed copy of ``t`` outside autograd (counts, reported losses)."""
    t = t.detach().clone()
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_detached(t: torch.Tensor, group, size: int, index: int) -> torch.Tensor:
    """The ranks' ``t`` stacked on a new leading axis (rank order), outside
    autograd; an all-reduce of a zero-filled buffer."""
    buf = torch.zeros((size, *t.shape), dtype=t.dtype, device=t.device)
    buf[index] = t.detach()
    if group is not None:
        dist.all_reduce(buf, group=group)
    return buf


class _GatherDim(torch.autograd.Function):
    """Concatenate the ranks' shards along ``dim``; the backward hands each
    rank its own slice of its own gradient.  Every rank then computes the
    same function of the gathered tensor, and the slices of its gradient
    together are that function's whole gradient, counted once."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        buf = all_gather_detached(x, group, size, index)
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return torch.cat(list(buf.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None


def gather_dim(x: torch.Tensor, dim: int, group, size: int, index: int) -> torch.Tensor:
    """``x``'s shards of the group concatenated along ``dim`` (rank order)."""
    if group is None:
        return x
    return _GatherDim.apply(x, dim, group, size, index)


# ---------------------------------------------------------------- H halos

# What lies past the global image edge: zero rows (a SAME conv's padding),
# copies of the edge row (a clamped resize), or nothing (the caller pads).
HALO_MODES = ("zeros", "edge", "none")


def _halo_rows(depth: int, h: int, size: int, index: int, mode: str):
    """The source of each halo row of rank ``index`` (shards of ``h`` rows):
    ``(top, bottom)`` lists of ``(rank, slot, row)``, or None for a zero
    row.  The edge buffer holds each rank's first (slot 0) and last (slot 1)
    ``min(depth, h)`` rows, so a halo deeper than a shard reads whole shards
    of ranks further away."""
    m = min(depth, h)
    total = size * h

    def source(g: int):
        if g < 0 or g >= total:
            if mode == "zeros":
                return None
            g = 0 if g < 0 else total - 1
        q, l = divmod(g, h)
        return (q, 0, l) if l < m else (q, 1, l - (h - m))

    def keep(g: int) -> bool:
        return mode != "none" or 0 <= g < total

    top = [source(g) for g in range(index * h - depth, index * h) if keep(g)]
    bottom = [source(g) for g in range((index + 1) * h, (index + 1) * h + depth) if keep(g)]
    return top, bottom


class _HaloH(torch.autograd.Function):
    """NCHW ``x`` with ``depth`` rows of the neighbouring ranks' H shards
    above and below (from several ranks away where ``depth`` exceeds a rank's
    rows).  The backward sends each halo row's gradient back to its owner and
    adds it there."""

    @staticmethod
    def forward(ctx, x, depth, mode, group, size, index):
        b, c, h, w = x.shape
        m = min(depth, h)
        edges = torch.zeros((size, 2, b, c, m, w), dtype=x.dtype, device=x.device)
        edges[index, 0] = x[:, :, :m]
        edges[index, 1] = x[:, :, h - m:]
        dist.all_reduce(edges, group=group)
        top, bottom = _halo_rows(depth, h, size, index, mode)

        def row(src):
            if src is None:
                return x.new_zeros((b, c, 1, w))
            q, slot, l = src
            return edges[q, slot, :, :, l:l + 1]

        ctx.shape, ctx.m, ctx.group, ctx.size, ctx.index = x.shape, m, group, size, index
        ctx.top, ctx.bottom = top, bottom
        return torch.cat([row(s) for s in top] + [x] + [row(s) for s in bottom], dim=2)

    @staticmethod
    def backward(ctx, grad):
        b, c, h, w = ctx.shape
        m, top, bottom = ctx.m, ctx.top, ctx.bottom
        gx = grad[:, :, len(top):len(top) + h].clone()
        back = torch.zeros((ctx.size, 2, b, c, m, w), dtype=grad.dtype, device=grad.device)
        halo = list(enumerate(top)) + [(len(top) + h + i, s) for i, s in enumerate(bottom)]
        for pos, src in halo:
            if src is not None:
                q, slot, l = src
                back[q, slot, :, :, l] += grad[:, :, pos]
        dist.all_reduce(back, group=ctx.group)
        gx[:, :, :m] += back[ctx.index, 0]
        gx[:, :, h - m:] += back[ctx.index, 1]
        return gx, None, None, None, None, None


def halo_h(x: torch.Tensor, depth: int, mode: str = "zeros") -> torch.Tensor:
    """``x`` (NCHW, this rank's H shard under the active mesh's ``spatial``
    axis) with ``depth`` halo rows on each side; at the global image edges
    ``mode`` decides (:data:`HALO_MODES`; :func:`halo_rows_added` says how
    many rows were added).  Without a spatial axis: ``x``."""
    if mode not in HALO_MODES:
        raise ValueError(f"halo mode {mode!r} not in {HALO_MODES}")
    mesh = _ACTIVE
    if mesh is None or mesh.size("spatial") == 1:
        return x
    return _HaloH.apply(x, depth, mode, mesh.group_of(("spatial",)), mesh.size("spatial"),
                        mesh.index("spatial"))


def halo_rows_added(depth: int, h: int, mode: str) -> Tuple[int, int]:
    """Rows :func:`halo_h` adds (above, below) on this rank for a shard of
    ``h`` rows."""
    mesh = _ACTIVE
    if mesh is None or mesh.size("spatial") == 1:
        return 0, 0
    top, bottom = _halo_rows(depth, h, mesh.size("spatial"), mesh.index("spatial"), mode)
    return len(top), len(bottom)


# ----------------------------------------------- the step's reductions, by role


def bn_shards() -> int:
    """How many shards of the batch statistics' population the active mesh
    spreads over ranks with a process group (``data`` × ``spatial``), or 0
    where BatchNorm reduces locally (no mesh, or one process without a
    group)."""
    if _group(("data", "spatial")) is None:
        return 0
    return _ACTIVE.size("data") * _ACTIVE.size("spatial")


def bn_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks that hold parts of the batch statistics' population
    (``data`` × ``spatial``): sync-BN."""
    return all_reduce_sum(t, _group(("data", "spatial")))


def grad_group():
    """The group the gradients are summed over: the whole mesh."""
    return None if _ACTIVE is None else _ACTIVE.group_of(_ACTIVE.axis_names)


def loss_group():
    """The group the loss reduces over: ``data``.  Every ``spatial`` rank of
    a data shard computes the loss on the whole (gathered) images."""
    return _group(("data",))


def spatial_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the ``spatial`` ranks (a global mean over H×W)."""
    return all_reduce_sum(t, _group(("spatial",))) if spatial_shards() > 1 else t


def spatial_amax(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """``x.amax(dims)`` over the whole image height."""
    if spatial_shards() == 1:
        return x.amax(dim=dims)
    return all_reduce_amax(x, dims, _group(("spatial",)))


def gather_h(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole images of this rank's data shard: the ``spatial`` shards of
    ``x`` gathered along ``dim`` (NHWC: 1)."""
    if spatial_shards() == 1:
        return x
    mesh = _ACTIVE
    return gather_dim(x, dim, mesh.group_of(("spatial",)), mesh.size("spatial"),
                      mesh.index("spatial"))


def local_slice(t: torch.Tensor, h_dim: Optional[int]) -> torch.Tensor:
    """This rank's part of a tensor drawn at the global shape: its ``data``
    rows (dim 0) and, with ``h_dim``, its ``spatial`` rows there."""
    mesh = _ACTIVE
    if mesh is None:
        return t
    d, nd = mesh.index("data"), mesh.size("data")
    t = t.narrow(0, d * (t.shape[0] // nd), t.shape[0] // nd)
    if h_dim is not None:
        s, ns = mesh.index("spatial"), mesh.size("spatial")
        t = t.narrow(h_dim, s * (t.shape[h_dim] // ns), t.shape[h_dim] // ns)
    return t


def global_shape(shape: Sequence[int], h_dim: Optional[int]) -> List[int]:
    """The global shape of a local tensor of ``shape`` (see :func:`local_slice`)."""
    mesh = _ACTIVE
    shape = list(shape)
    if mesh is not None:
        shape[0] *= mesh.size("data")
        if h_dim is not None:
            shape[h_dim] *= mesh.size("spatial")
    return shape
