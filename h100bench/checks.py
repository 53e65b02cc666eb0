"""The readings that decide ``correct``; a cell's file
(``workloads/<cell>.json``) names the ones it compares, each with its limit,
and the rest are reported on standard error.

Serving (``drive_serve.serve_numbers``): the restored images the timed
forward produced against the reference's, over a sample drawn from the seed.

Training (:func:`train_numbers`): the three set-up steps against the
reference's.  ``loss_gap`` is the largest relative gap of a step's loss and
``loss_gap.first`` the first step's.  For the first gradient (as Adam's first
moment holds it after step 1, ``grad``), the parameters' change over the
three steps (``update``) and the running statistics' change (``bn``):
``<kind>_gap`` is the worst leaf's gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of the
median leaf; ``<kind>_gap.median`` the median leaf's; ``<kind>_gap.global``
the gap of the norms of all leaves as one vector; ``<kind>_cos`` one minus
their cosine.  ``bn1`` is the running statistics' change after the first
step alone, before the two sides' parameters part.  ``<kind>_diff`` is the
worst leaf's norm of the difference, ‖prog − ref‖, over the same
denominator, and ``<kind>_diff.median`` the median leaf's.  Leaves whose
reference gradient is under a thousandth of the median leaf's (a conv's
bias in front of a train-mode BatchNorm, whose gradient is nought but for
rounding) are left out of ``grad`` and ``update``: only round-off moves
them.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List

import torch

QUIET_GRAD = 1e-3  # × the median leaf's gradient norm


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN compares false: not ok

    def line(self) -> str:
        return f"{self.name} {self.value!r} <= {self.limit!r} {'ok' if self.ok else 'FAILED'}"


def judge(values: Dict[str, float], limits: Dict) -> List[Check]:
    """Each number the cell file gives a limit, beside it (the others are
    reported on standard error only)."""
    return [Check(name, float(values[name]), float(spec["limit"]))
            for name, spec in limits["numbers"].items()]


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: List[str]) -> Dict[str, float]:
    """Per leaf: |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    pn, rn = _norms({k: prog[k] for k in names}), _norms({k: ref[k] for k in names})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               names: List[str]) -> Dict[str, float]:
    """Per leaf: ‖prog − ref‖ / max(‖ref‖, median leaf ‖ref‖)."""
    rn = _norms({k: ref[k] for k in names})
    med = statistics.median(rn.values())
    return {k: float((prog[k].double() - ref[k].double()).norm()) / max(rn[k], med, 1e-30)
            for k in names}


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(ref_grads)
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= QUIET_GRAD * med]


def train_numbers(prog: Dict, ref: Dict, state0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog`` / ``ref``: ``losses``, ``grads``, ``params``, ``buffers``
    (after the last step), ``buffers1`` (after the first); ``state0``: the
    weights both started from."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    moving = moving_leaves(ref["grads"])

    def change(side, key, names):
        return {k: side[key][k].double() - state0[k].double() for k in names}

    stats = list(ref["buffers"])
    pairs = {"grad": (prog["grads"], ref["grads"], moving),
             "update": (change(prog, "params", moving), change(ref, "params", moving), moving),
             "bn": (change(prog, "buffers", stats), change(ref, "buffers", stats), stats),
             "bn1": (change(prog, "buffers1", stats), change(ref, "buffers1", stats), stats)}
    out = {"loss_gap": loss_gap,
           "loss_gap.first": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])}
    for kind, (p_side, r_side, names) in pairs.items():
        out[f"{kind}_gap.global"] = global_gap(p_side, r_side, names)
        out[f"{kind}_cos"] = cosine_gap(p_side, r_side, names)
        for measure, per_leaf in (("gap", leaf_gaps), ("diff", leaf_diffs)):
            g = per_leaf(p_side, r_side, names)
            out[f"{kind}_{measure}"] = max(g.values())
            out[f"{kind}_{measure}.median"] = statistics.median(g.values())
            out[f"{kind}_{measure}.worst"] = " ".join(
                f"{k}={v:.4g}" for k, v in sorted(g.items(), key=lambda kv: -kv[1])[:3])
    return out


def cosine_gap(prog, ref, names) -> float:
    """1 − cos(prog, ref) over all leaves ``names`` as one vector."""
    dot = sum(float((prog[k].double() * ref[k].double()).sum()) for k in names)
    pn = sum(float(prog[k].double().square().sum()) for k in names) ** 0.5
    rn = sum(float(ref[k].double().square().sum()) for k in names) ** 0.5
    return 1.0 - dot / max(pn * rn, 1e-300)


def global_gap(prog, ref, names) -> float:
    """|‖prog‖ − ‖ref‖| / ‖ref‖ over all leaves ``names`` as one vector."""
    pn = sum(float(prog[k].double().square().sum()) for k in names) ** 0.5
    rn = sum(float(ref[k].double().square().sum()) for k in names) ** 0.5
    return abs(pn - rn) / max(rn, 1e-30)
