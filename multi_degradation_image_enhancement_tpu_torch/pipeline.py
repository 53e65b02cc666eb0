"""Classify → route → restore: the routed serving pipeline (counterpart of
``multi_degradation_image_enhancement_tpu/pipeline.py``).

A multi-label classifier scores each image for the nine degradations, and a
bank of per-degradation CDAN restorers (one ``CDAN_<task>.pt`` each) restores
it:

* **top1**: each image visits its argmax expert, up to a capacity of
  ``max(1, ceil(B / E · capacity_factor))`` images per expert in batch order;
  images over capacity pass through unrestored;
* **sequential**: every expert whose probability clears its threshold
  applies, one after the other over the batch with masked updates, in bank
  order (``fixed``) or ordered by the severity head (``severity``: highest
  mean severity first; ``severity_asc``: the control direction);
* clean images (no probability at its threshold) pass through untouched.

The JAX package stacks the experts on an expert axis and routes with one-hot
dispatch and combine einsums so that one jitted program runs the bank; here
each expert is its own forward, and the rows routed to it are gathered,
restored and scattered back.  The result is the same: each one-hot sum has a
single 1.0 term per row, exact in f32, and the eval forward treats every
image on its own.  An expert with no row to restore is not run.  Each
expert's forward is the one the JAX pipeline applies: the eval module with
unfused DenseBlocks (``models.cdan.eval_forward``; bf16 autocast on the
card), not the fused serving forward.

Expert-parallel serving (``mesh`` with an ``expert`` axis, the JAX
package's ``pipeline.py:100-120``; one process per GPU): the bank is padded
to a multiple of the axis (``n_pad`` dummy experts, never routed to) and
each rank holds a contiguous block of it, JAX's ``P(EXPERT_AXIS)`` layout
(:func:`expert_block`; the CLI loads only those).  Every batch's routes
are decided once, on the mesh's first rank, and broadcast, so no two ranks
can split on a probability at its threshold.  In top1 each rank restores
its experts' rows into a zero batch and an all-reduce sum combines them
(exact: each row has one contributor); clean and dropped rows pass
through.  In sequential mode, expert by expert in the decided order, the
owner restores the masked rows and an all-reduce of the zero-padded rows
hands them to every rank.  A ``data`` axis splits each expert's rows over
its ranks.  Every rank returns the whole batch.

Spans (``utils.tracing``, each a device range on the batch's card too) and
counters, for the benchmark's per-layer metrics:

* ``pipeline/forward``: one :class:`FullPipeline` call, whole;
* ``pipeline/classify``: normalisation, the classifier, its sigmoids and the
  column permutation (:meth:`FullPipeline.classify_full`);
* ``pipeline/route``: top1's routing (:meth:`RoutedRestorer.route`);
* ``pipeline/expert``: one expert's gather, forward and scatter, in every
  mode and on the expert-parallel path;
* :class:`RoutedRestorer`'s counters, plain integers that only grow, from
  sizes the host already holds (no sync of their own): ``expert_calls``
  (expert forwards run; ``expert_forwards`` names the bank's callables),
  ``routed_rows`` (rows through an expert's forward), and top1's
  ``dropped_rows`` and ``clean_rows`` (the decisions of the rank's own
  :meth:`RoutedRestorer.route`; sequential mode counts neither).

On the card the host sets the pace unless it stays ahead: an eager expert
forward enqueues some hundreds of kernels for 3–4 rows.  So top1 decides
every route on the device and reads back one vector of sizes (the one sync
a batch), and the experts and the classifier run as CUDA graphs, one for
each input shape, captured on its first call (:func:`cuda_graphed`): the
same kernels on the same shapes, so the same outputs.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.classification.model import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN, eval_forward
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS
from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span

Forward = Callable[[torch.Tensor], torch.Tensor]

# Routes of top1 mode (:meth:`RoutedRestorer.route`): an expert index, or one of these.
CLEAN, DROPPED = -1, -2


def cuda_graphed(forwards: Sequence[Optional[Callable]]) -> List[Optional[Callable]]:
    """Each of ``forwards`` (one tensor in; a tensor or a tuple of tensors
    out) replayed from a CUDA graph, one for each input shape and dtype,
    captured on the first call at that shape after two eager calls on a side
    stream (where cuDNN and cuBLAS choose and allocate).  The graphs of the
    list share one memory pool, and each call copies its outputs out of the
    graph's buffers, so no later replay can overwrite what a caller holds.
    A CPU input runs the forward as it is; None stays None.  ``.captures``
    on each counts its graphs."""
    pool = []  # the shared pool's handle, made at the first capture

    def graphed(forward: Callable) -> Callable:
        graphs = {}

        def run(x: torch.Tensor):
            if x.device.type != "cuda":
                return forward(x)
            key = (tuple(x.shape), x.dtype, x.device)
            if key not in graphs:
                if not pool:
                    pool.append(torch.cuda.graph_pool_handle())
                static_in = x.clone()
                side = torch.cuda.Stream(x.device)
                side.wait_stream(torch.cuda.current_stream(x.device))
                with torch.cuda.stream(side):
                    for _ in range(2):
                        forward(static_in)
                torch.cuda.current_stream(x.device).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool[0]):
                    static_out = forward(static_in)
                graphs[key] = (graph, static_in, static_out)
                run.captures += 1
            graph, static_in, static_out = graphs[key]
            static_in.copy_(x)
            graph.replay()
            if isinstance(static_out, torch.Tensor):
                return static_out.clone()
            return tuple(t.clone() for t in static_out)

        run.captures = 0
        return run

    return [None if f is None else graphed(f) for f in forwards]


def load_expert_bank(weight_paths: Dict[str, str], device, dtype,
                     only: Optional[Sequence[int]] = None
                     ) -> Tuple[List[str], List[Optional[Forward]]]:
    """Load each expert's ``CDAN_<task>.pt`` strictly onto ``device`` and
    build its forward: the eval module in ``dtype`` (``eval_forward``: every
    DenseBlock unfused, a bf16 autocast for bf16), as the JAX pipeline
    applies ``CDAN(dtype)`` (``pipeline.py:125-126``).  ``weight_paths``
    maps degradation name → weight file; returns (expert order, forwards).
    ``only`` (an expert-parallel rank's :func:`expert_block`) loads those
    experts and leaves None for the others.  On the card each forward
    replays a CUDA graph of itself (:func:`cuda_graphed`)."""
    names = list(weight_paths)
    forwards: List[Optional[Forward]] = []
    for e, name in enumerate(names):
        path = weight_paths[name]
        if not os.path.isfile(path):
            raise FileNotFoundError(f"Expert '{name}' weights not found: {path}")
        if only is not None and e not in only:
            forwards.append(None)
            continue
        model = load_weights(path, CDAN()).to(device).eval()
        forwards.append(eval_forward(model, dtype))
    return names, cuda_graphed(forwards)


def expert_block(n_experts: int, mesh) -> range:
    """The experts a rank holds on ``mesh``'s ``expert`` axis: its contiguous
    block of the bank padded to a multiple of the axis, real experts only
    (every expert without an expert axis)."""
    if mesh is None or EXPERT_AXIS not in mesh.axis_names:
        return range(n_experts)
    axis = mesh.size(EXPERT_AXIS)
    block = (n_experts + (-n_experts) % axis) // axis
    lo = mesh.index(EXPERT_AXIS) * block
    return range(min(lo, n_experts), min(lo + block, n_experts))


class RoutedRestorer:
    """A routed bank of per-degradation restorers behind one callable.

    ``expert_forwards[e]`` maps NHWC [N,H,W,3] in [0, 1] to restored f32
    images of the same shape (any callable: tests give tiny nets).  With a
    ``mesh`` that has an ``expert`` axis only the rank's block
    (:func:`expert_block`) is kept and called; the others may be None."""

    def __init__(self, expert_forwards: Sequence[Optional[Forward]], expert_names: Sequence[str],
                 mode: str = "top1", capacity_factor: float = 2.0, ordering: str = "fixed",
                 mesh=None):
        if mode not in ("top1", "sequential"):
            raise ValueError(f"Unknown routing mode: {mode}")
        if ordering not in ("fixed", "severity", "severity_asc"):
            raise ValueError(f"Unknown sequential ordering: {ordering}")
        if len(expert_forwards) != len(expert_names):
            raise ValueError("one forward per expert name")
        self.expert_names = list(expert_names)
        self.mode = mode
        self.ordering = ordering
        self.capacity_factor = float(capacity_factor)
        self.mesh = mesh if mesh is not None and EXPERT_AXIS in mesh.axis_names else None
        n = len(self.expert_names)
        self.n_pad = 0 if self.mesh is None else (-n) % self.mesh.size(EXPERT_AXIS)
        self.owned = expert_block(n, self.mesh)
        self.expert_forwards = [f if e in self.owned else None
                                for e, f in enumerate(expert_forwards)]
        if any(self.expert_forwards[e] is None for e in self.owned):
            raise ValueError(f"a forward is missing for this rank's experts {list(self.owned)}")
        self.expert_calls = 0
        self.routed_rows = 0
        self.dropped_rows = 0
        self.clean_rows = 0

    def _restore(self, out: torch.Tensor, rows: torch.Tensor, forward: Forward,
                 src: torch.Tensor, src_rows: Optional[torch.Tensor] = None) -> None:
        """``out[rows] = forward(src[src_rows])`` (``src_rows`` defaults to
        ``rows``), counted, in a ``pipeline/expert`` span."""
        with span("pipeline/expert", out.device):
            out[rows] = forward(src[rows if src_rows is None else src_rows]).float()
        self.expert_calls += 1
        self.routed_rows += rows.numel()

    def capacity(self, batch: int) -> int:
        return max(1, int(math.ceil(batch / len(self.expert_names) * self.capacity_factor)))

    def route(self, probs: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
        """Top1 routes [B]: each row's argmax expert (taken even when that
        expert's own probability is under its threshold, as long as some
        class clears its own), :data:`CLEAN` when no class does, or
        :data:`DROPPED` when its expert's bucket is full (rank by batch order)."""
        return self._route(probs, thresholds)[0]

    def _route(self, probs: torch.Tensor, thresholds: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
        """(:meth:`route`'s routes, the rows sorted by route (dropped, clean,
        then each expert's in batch order), the sizes of those groups).  All
        is decided on the device; reading the sizes back is the one sync."""
        with span("pipeline/route", probs.device):
            n_experts = len(self.expert_names)
            expert_id = probs.argmax(dim=-1)  # the first maximum, as jnp.argmax
            active = (probs >= thresholds).any(dim=-1)
            queued = F.one_hot(expert_id, n_experts) * active[:, None]
            place = (queued.cumsum(dim=0) * queued).sum(dim=-1)  # 1-based, in batch order
            kept = torch.where(place <= self.capacity(probs.shape[0]), expert_id, DROPPED)
            routes = torch.where(active, kept, CLEAN)
            by_route = torch.argsort(routes, stable=True)
            sizes = F.one_hot(routes - DROPPED, n_experts + 2).sum(dim=0).tolist()
            self.dropped_rows += sizes[0]
            self.clean_rows += sizes[1]
            return routes, by_route, sizes

    def order(self, probs: torch.Tensor, thresholds: torch.Tensor,
              severities: Optional[torch.Tensor]) -> List[int]:
        """Sequential mode's application order of the bank."""
        n = len(self.expert_names)
        if self.ordering == "fixed" or severities is None:
            return list(range(n))
        active = (probs >= thresholds[None, :]).float()
        score = (severities.float() * active).sum(dim=0) / active.sum(dim=0).clamp_min(1.0)
        key = -score if self.ordering == "severity" else score
        return torch.argsort(key, stable=True).tolist()  # ties keep bank order, as jnp.argsort

    def __call__(self, images: torch.Tensor, probs: torch.Tensor, thresholds,
                 severities: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Restore a batch given classifier probabilities.

        ``images`` [B,H,W,3] f32 in [0, 1]; ``probs`` [B,E] with columns in
        ``expert_names`` order; ``thresholds`` [E]; ``severities`` [B,E]
        (the severity head's sigmoids) drive the order of sequential mode
        with a severity ordering.  Returns f32 [B,H,W,3]."""
        thresholds = torch.as_tensor(thresholds, dtype=torch.float32, device=probs.device)
        out = images.float().clone()
        if self.mesh is not None:
            return self._expert_parallel(images, out, probs, thresholds, severities)
        if self.mode == "top1":
            _, by_route, sizes = self._route(probs, thresholds)
            by_route = by_route.to(images.device)
            start = sizes[0] + sizes[1]
            for e, forward in enumerate(self.expert_forwards):
                if sizes[2 + e]:
                    self._restore(out, by_route[start:start + sizes[2 + e]], forward, images)
                start += sizes[2 + e]
            return out
        for e in self.order(probs, thresholds, severities):
            rows = torch.nonzero(probs[:, e] >= thresholds[e]).flatten().to(images.device)
            if rows.numel():
                self._restore(out, rows, self.expert_forwards[e], out)
        return out


    def _expert_parallel(self, images, out, probs, thresholds, severities):
        """The call on an expert mesh (see the module's docstring)."""
        mesh = self.mesh
        group, src = mesh.group_of(mesh.axis_names), mesh.ranks[0]
        b = images.shape[0]
        chunk = -(-b // mesh.size(DATA_AXIS))
        mine = torch.zeros((b,), dtype=torch.bool, device=images.device)
        mine[mesh.index(DATA_AXIS) * chunk:(mesh.index(DATA_AXIS) + 1) * chunk] = True

        def decided(t: torch.Tensor) -> torch.Tensor:  # the first rank's decision, everywhere
            t = t.contiguous()
            if group is not None:
                dist.broadcast(t, src=src, group=group)
            return t

        def combined(t: torch.Tensor) -> torch.Tensor:  # one contributor a row: exact
            if group is not None:
                dist.all_reduce(t, group=group)
            return t

        if self.mode == "top1":
            routes = decided(self.route(probs, thresholds).to(images.device))
            restored = torch.zeros_like(out)
            for e in self.owned:
                rows = torch.nonzero((routes == e) & mine).flatten()
                if rows.numel():
                    self._restore(restored, rows, self.expert_forwards[e], images)
            restored = combined(restored)
            return torch.where((routes >= 0)[:, None, None, None], restored, out)
        order = decided(torch.tensor(self.order(probs, thresholds, severities),
                                     device=images.device))
        active = decided((probs >= thresholds[None, :]).to(torch.uint8).to(images.device))
        for e in order.tolist():
            rows = torch.nonzero(active[:, e]).flatten()
            if not rows.numel():
                continue
            part = torch.zeros((rows.numel(), *out.shape[1:]), dtype=out.dtype, device=out.device)
            if e in self.owned:
                here = torch.nonzero(mine[rows]).flatten()
                if here.numel():
                    self._restore(part, here, self.expert_forwards[e], out, rows[here])
            out[rows] = combined(part)
        return out


class FullPipeline:
    """Degraded image in → classified, routed, restored image out.

    ``classifier`` is a ``MultiHeadClassifier`` already on its device and in
    its dtype (``classification.model.serving_classifier``); on the card it
    runs as a CUDA graph of itself (:func:`cuda_graphed`)."""

    def __init__(self, classifier: torch.nn.Module, router: RoutedRestorer,
                 thresholds: Sequence[float], classes: Optional[Sequence[str]] = None):
        self.classifier = classifier
        self.router = router
        classes = list(classes or DEGRADATIONS)
        self.classifier_forward = cuda_graphed([classifier])[0]
        device = next(classifier.parameters()).device
        # column permutation from classifier class order → expert order, on the device (a
        # list index would be copied to the card, and waited for, at each call)
        self.perm = torch.tensor([classes.index(n) for n in router.expert_names], device=device)
        self.mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
        self.std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
        self.thresholds = torch.as_tensor(thresholds, dtype=torch.float32, device=device)[self.perm]

    @torch.inference_mode()
    def classify_full(self, images01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(probabilities, severities) [B,E] in expert order."""
        with span("pipeline/classify", self.mean.device):
            cls_logits, sev_logits = self.classifier_forward((images01 - self.mean) / self.std)
            return torch.sigmoid(cls_logits)[:, self.perm], torch.sigmoid(sev_logits)[:, self.perm]

    def classify(self, images01: torch.Tensor) -> torch.Tensor:
        return self.classify_full(images01)[0]

    @torch.inference_mode()
    def __call__(self, images01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (restored images, per-degradation probabilities)."""
        with span("pipeline/forward", self.mean.device):
            images01 = images01.to(self.mean.device)
            if self.router.mode == "sequential" and self.router.ordering != "fixed":
                probs, sevs = self.classify_full(images01)
                return self.router(images01, probs, self.thresholds, severities=sevs), probs
            probs = self.classify(images01)
            return self.router(images01, probs, self.thresholds), probs
