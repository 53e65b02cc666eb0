"""Named process mesh and sharding rules: the port's scale-out layer
(counterpart of ``multi_degradation_image_enhancement_tpu/parallel/mesh.py``).

One process per GPU (``torchrun``), arranged in a mesh with named axes:

* ``data``: shards the batch (data parallel);
* ``spatial``: shards the image height (the conv halo exchanges and global
  reductions of ``parallel.collectives``);
* ``expert``: shards the routed server's bank of restorers (``pipeline``).

``train.mesh`` in a task config: ``{"data": -1}`` puts every process on the
data axis; ``{"data": 2, "spatial": 2}`` is a 4-process 2-D layout.  Axis
size ``-1`` means "all remaining processes".  Ranks fill the mesh row-major,
as JAX reshapes its device list: in ``{"data": 2, "spatial": 2}`` ranks 0
and 1 hold the two H halves of data shard 0.

Where XLA partitions a jitted step by sharding annotations, the port runs
the single-device step on each rank's shard under the mesh
(:func:`shard_train_step`), and the model, the losses and the optimizer
insert the collectives themselves: sync-BN over ``data`` × ``spatial``,
halo rows and global pools over ``spatial``, the loss's means over
``data``, one all-reduce of the gradients before the update.  A sharded
step is the single-device step on the global batch.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multi_degradation_image_enhancement_tpu_torch.parallel import collectives

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
EXPERT_AXIS = "expert"


class Mesh:
    """This process's view of a named mesh: the axes' sizes, its coordinate
    on each, and a process group over every subset of the axes (None for
    each when no process group is initialised: one process, no collective)."""

    def __init__(self, axes: Dict[str, int], ranks: Sequence[int], rank: int, groups: Dict):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.ranks = list(ranks)
        self.rank = rank
        grid = np.asarray(self.ranks).reshape(tuple(axes.values()))
        coords = np.argwhere(grid == rank)[0]
        self.coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        self._groups = groups

    def size(self, axis: str) -> int:
        """The axis's size (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This process's coordinate on the axis (0 for an absent axis)."""
        return self.coords.get(axis, 0)

    def group_of(self, axes: Sequence[str]):
        """The process group of this process's line (plane) along ``axes``;
        absent axes are left out, and None when none is left or there is no
        process group."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups.get(key) if key else None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def _fill_axes(axes: Dict[str, int], n: int) -> Dict[str, int]:
    """JAX's rules (``parallel/mesh.py:33-56``): one ``-1`` fills, and the
    product must equal ``n``."""
    axes = dict(axes)
    fill = [k for k, v in axes.items() if v == -1]
    fixed = int(np.prod([v for v in axes.values() if v != -1])) if axes else 1
    if fill:
        if len(fill) > 1:
            raise ValueError("Only one mesh axis may be -1")
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {axes}")
        axes[fill[0]] = n // fixed
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(f"Mesh {axes} wants {total} devices, have {n}")
    return axes


def create_mesh(axes: Optional[Dict[str, int]] = None, ranks: Optional[Sequence[int]] = None
                ) -> Mesh:
    """Build a named mesh over ``ranks`` (default: every process of the
    default group, or this one process without a group).  ``axes`` maps axis
    name → size (-1 = fill); no axes means ``{"data": n}``.  Every process of
    the default group must call it (process groups are created
    collectively)."""
    initialised = dist.is_available() and dist.is_initialized()
    if ranks is None:
        ranks = list(range(dist.get_world_size())) if initialised else [0]
    ranks = list(ranks)
    n = len(ranks)
    axes = _fill_axes(axes or {DATA_AXIS: n}, n)
    rank = dist.get_rank() if initialised else ranks[0]
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not in the mesh's ranks {ranks}")
    groups = {}
    if initialised:
        grid = np.asarray(ranks).reshape(tuple(axes.values()))
        names = tuple(axes)
        for r in range(1, len(names) + 1):
            for sub in itertools.combinations(range(len(names)), r):
                # one group per line (plane) along ``sub``: fix the other axes
                moved = np.moveaxis(grid, sub, tuple(range(len(sub))))
                lines = moved.reshape(math.prod(moved.shape[:len(sub)]), -1).T
                for line in lines:
                    members = sorted(int(x) for x in line)
                    group = dist.new_group(members)
                    if rank in members:
                        groups[tuple(names[i] for i in sub)] = group
    return Mesh(axes, ranks, rank, groups)


def mesh_from_config(axes: Optional[Dict[str, int]]) -> Optional[Mesh]:
    """The mesh of ``train.mesh``, or None to run the plain step: no mesh
    asked for, or a one-process mesh without a process group.  A mesh whose
    size is not the world's raises (nothing trains on fewer processes than
    the config shards over)."""
    if not axes:
        return None
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    fixed = math.prod(v for v in axes.values() if v != -1)
    if (-1 in axes.values() and world % fixed) or (-1 not in axes.values() and fixed != world):
        want = fixed if -1 not in axes.values() else f"a multiple of {fixed}"
        raise ValueError(f"train.mesh {dict(axes)} needs {want} processes, this run has {world}: "
                         f"launch one process per GPU with torchrun --nproc_per_node N, N = "
                         f"{want} (run.py joins the process group under torchrun)")
    mesh = create_mesh(axes)
    return mesh if mesh.group_of(mesh.axis_names) is not None else None


def batch_spec(mesh: Mesh) -> Tuple[str, Optional[str]]:
    """The sharding of an NHWC image batch: batch over ``data``, H over
    ``spatial`` when the mesh has that axis (JAX's ``P(DATA_AXIS, spatial)``)."""
    return (DATA_AXIS, SPATIAL_AXIS if SPATIAL_AXIS in mesh.axis_names else None)


def batch_sharding(mesh: Mesh, batch: int, height: Optional[int] = None
                   ) -> Tuple[slice, Optional[slice]]:
    """The rows of the global batch and, with ``height``, the H rows this
    process holds.  Raises unless the axes divide them."""
    nd, ns = mesh.size(DATA_AXIS), mesh.size(SPATIAL_AXIS)
    if batch % nd:
        raise ValueError(f"batch {batch} does not split over the data axis of {nd}")
    b = batch // nd
    rows = slice(mesh.index(DATA_AXIS) * b, (mesh.index(DATA_AXIS) + 1) * b)
    if height is None:
        return rows, None
    if height % ns:
        raise ValueError(f"height {height} does not split over the spatial axis of {ns}")
    h = height // ns
    return rows, slice(mesh.index(SPATIAL_AXIS) * h, (mesh.index(SPATIAL_AXIS) + 1) * h)


def replicated(mesh: Mesh):
    """The process group over which replicated state is kept equal (the
    whole mesh; None without process groups)."""
    return mesh.group_of(mesh.axis_names)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This process's shard of a global batch (a tensor, or a tuple, list or
    dict of them; None passes): NHWC images keep their ``data`` rows and
    ``spatial`` H rows, a ``[B]`` vector (the validity mask) its rows."""
    if batch is None:
        return None
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, mesh) for x in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    height = batch.shape[1] if batch.dim() >= 3 else None
    rows, hs = batch_sharding(mesh, batch.shape[0], height)
    out = batch[rows]
    return out[:, hs] if hs is not None else out


def replicate(obj: Any, mesh: Mesh) -> Any:
    """Broadcast a module's parameters and buffers, a ``TrainState``'s model
    and optimizer state, or a tensor, from the mesh's first process to every
    process of the mesh, in place; returns ``obj``."""
    group = replicated(mesh)
    if group is None:
        return obj
    tensors = []
    if isinstance(obj, torch.Tensor):
        tensors = [obj]
    elif isinstance(obj, torch.nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    else:  # a TrainState
        tensors = list(obj.model.parameters()) + list(obj.model.buffers())
        for state in obj.optimizer.state.values():
            tensors += [v for v in state.values() if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=mesh.ranks[0], group=group)
    return obj


def shard_train_step(step_fn, mesh: Mesh):
    """The train step on this process's shard of the batch: ``call(state,
    inputs, targets, dropout=None, mask=None)`` with the shards of
    :func:`shard_batch` and the global step's dropout generator (or the
    global keep masks).  The step runs under the mesh: its BatchNorms reduce
    over ``data`` × ``spatial``, its loss over ``data``, and
    ``TrainState.apply_gradients`` all-reduces the gradients before clipping
    and Adam.  Returns the loss dict of the global batch."""

    def call(state, inputs, targets, dropout=None, mask=None):
        with collectives.use_mesh(mesh):
            losses = step_fn(state, inputs, targets, dropout, mask)
            group = collectives.loss_group()
        return {k: collectives.all_reduce_detached(v, group) for k, v in losses.items()}

    return call


def shard_eval_step(step_fn, mesh: Mesh):
    """An eval forward on this process's shard: ``call(*args)`` runs
    ``step_fn`` under the mesh (halo exchanges under ``spatial``) and
    returns its output shard."""

    def call(*args, **kwargs):
        with collectives.use_mesh(mesh):
            return step_fn(*args, **kwargs)

    return call
