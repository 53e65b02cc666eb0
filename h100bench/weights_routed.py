"""The routed cell's weights, made from ``--seed``, and the files the
program's CLI reads, written by the program's own writers.

No trained classifier ships, and a ResNet-18 with random weights sends
nearly every photo to one expert.  So the backbone is seeded (He-normal
kernels, BatchNorm scale 1 ± 0.1 and shift ± 0.1, its running statistics
calibrated by the reference on the whole pool), and the class head is
*fitted* at set-up, standing in for training: ridge least squares on the
reference's float32 pooled features of the pool, with logit targets
+:data:`TARGET` for each image's own family and −:data:`TARGET` for the
others (σ(4) = 0.982 clears the highest packaged threshold, 0.95).  The
backbone is drawn again until, on every pool row, in the reference and in
the program's serving classifier alike (bf16 backbone, f32 heads on the
card), the head's argmax is the row's family, its top logit leads the
second by at least :data:`MARGIN`, and its own class clears that class's
routing threshold by a logit of :data:`CLEAR`: routes a trained classifier
would give, far from any tie or threshold that rounding could flip.  The
severity head stays seeded (top-1 routing does not read it).

Each expert is drawn as the serving cells draw CDAN
(``drive_serve.calibrated_state``), its statistics calibrated on its own
family's rows.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence

import torch

from h100bench.drive_serve import calibrated_state
from h100bench.reference import exact_f32
from h100bench.reference.cdan import split_state
from h100bench.reference.resnet import IMAGENET_MEAN, IMAGENET_STD, RefResNet18, resnet_shapes

TARGET = 4.0  # logit of a family's own class; −TARGET for the others
MARGIN = 2.0  # least top-1 − top-2 logit over the pool, on both sides
CLEAR = 0.5  # least logit by which a row's own class clears that class's threshold
RIDGE = 1e-5  # × the largest eigenvalue of the standardised features' Gram matrix
DRAWS = 8
CHUNK = 16  # rows a classifier pass takes at once


@torch.no_grad()
def resnet_state(gen: torch.Generator, device, num_classes: int) -> Dict[str, torch.Tensor]:
    """Seeded classifier weights by name (float32): conv kernels N(0,
    2/fan_in), BatchNorm scale 1 ± 0.1, shift ± 0.1, running mean ± 0.1,
    variance 1 ± 0.2 (uniform); heads N(0, 1/512), biases N(0, 0.02²)."""
    state = {}
    for name, shape in resnet_shapes(num_classes).items():
        t = torch.empty(shape, device=device)
        if len(shape) == 4:
            t.normal_(0.0, math.sqrt(2.0 / math.prod(shape[1:])), generator=gen)
        elif len(shape) == 2:
            t.normal_(0.0, math.sqrt(1.0 / shape[1]), generator=gen)
        elif name.startswith("head"):
            t.normal_(0.0, 0.02, generator=gen)
        else:
            t.uniform_(-1.0, 1.0, generator=gen)
            if name.endswith("running_var"):
                t.mul_(0.2).add_(1.0)
            elif name.endswith("weight"):
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.1)
        state[name] = t
    return state


def fit_head(feat: torch.Tensor, family: torch.Tensor, classes: int):
    """(weight [classes, 512], bias [classes]) of the ridge fit, float32;
    solved in float64 on the host."""
    f = feat.double().cpu()
    target = torch.full((f.shape[0], classes), -TARGET, dtype=torch.float64)
    target[torch.arange(f.shape[0]), family.cpu()] = TARGET
    mu, sd = f.mean(dim=0), f.std(dim=0).clamp(min=1e-12)
    z = (f - mu) / sd
    t_mean = target.mean(dim=0)
    u, s, vh = torch.linalg.svd(z, full_matrices=False)
    lam = RIDGE * float(s[0]) ** 2
    wz = vh.T @ torch.diag(s / (s * s + lam)) @ u.T @ (target - t_mean)  # [512, classes]
    w = wz / sd[:, None]
    b = t_mean - mu @ w
    return w.T.float().to(feat.device), b.float().to(feat.device)


def _classifier_module(state: Dict[str, torch.Tensor]):
    from multi_degradation_image_enhancement_tpu_torch.classification.model import (
        MultiHeadClassifier,
    )

    model = MultiHeadClassifier(state["head_cls.weight"].shape[0])
    model.load_state_dict({k: v.detach().float().cpu() for k, v in state.items()})
    return model.eval()


@torch.no_grad()
def program_logits(state: Dict[str, torch.Tensor], x01: torch.Tensor, device) -> torch.Tensor:
    """The class logits of the program's serving classifier
    (``classification.model.serving_classifier``: the backbone in bf16 on the
    card, f32 on the CPU, as ``run_pipeline.build_full_pipeline`` builds it)."""
    from multi_degradation_image_enhancement_tpu_torch.classification.model import (
        serving_classifier,
    )

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    clf = serving_classifier(_classifier_module(state), dtype, device)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    out = [clf((x01[i:i + CHUNK] - mean) / std)[0] for i in range(0, x01.shape[0], CHUNK)]
    return torch.cat(out).float()


def margins(logits: torch.Tensor) -> torch.Tensor:
    top = logits.topk(2, dim=1).values
    return top[:, 0] - top[:, 1]


def _separates(logits: torch.Tensor, family: torch.Tensor, floor: torch.Tensor):
    """(least top-2 margin, every argmax the row's family, every own class
    clearing its threshold by :data:`CLEAR`)."""
    return (float(margins(logits).min()), bool((logits.argmax(dim=1) == family).all()),
            bool((logits.gather(1, family[:, None])[:, 0] >= floor).all()))


@torch.no_grad()
def classifier_state(gen: torch.Generator, x01: torch.Tensor, family: torch.Tensor,
                     thresholds: torch.Tensor, device, log=None):
    """Seeded, calibrated and fitted classifier weights (see the module's
    docstring) for the pool's rows ``x01`` of families ``family``, with the
    reference's class logits of those rows; stops the run when no draw
    separates the families on both sides."""
    classes = thresholds.numel()
    floor = (torch.logit(thresholds.double()).float() + CLEAR)[family]
    seen = []
    for _ in range(DRAWS):
        state = resnet_state(gen, device, classes)
        ref = RefResNet18(*split_state(state))
        with exact_f32():
            ref.calibrate(x01)
            feat = torch.cat([ref.features(x01[i:i + CHUNK])
                              for i in range(0, x01.shape[0], CHUNK)])
        state["head_cls.weight"], state["head_cls.bias"] = fit_head(feat, family, classes)
        logits = feat @ state["head_cls.weight"].T + state["head_cls.bias"]
        ref_side = _separates(logits, family, floor)
        prog_side = _separates(program_logits(state, x01, device), family, floor)
        seen.append([round(ref_side[0], 3), round(prog_side[0], 3), ref_side[1:], prog_side[1:]])
        if all(s[1] and s[2] and s[0] >= MARGIN for s in (ref_side, prog_side)):
            if log is not None:
                log(f"classifier head fitted: least top-2 logit margin {ref_side[0]:.4f} "
                    f"(reference), {prog_side[0]:.4f} (program) over {family.numel()} pool rows "
                    f"(draws {seen})")
            return state, logits
    raise SystemExit(f"no draw of the classifier separates the nine families by a logit margin "
                     f"of {MARGIN} clearing the thresholds by {CLEAR} on both sides: [least "
                     f"margin reference, program, (argmax right, cleared) reference, program] "
                     f"per draw {seen}")


def expert_states(gen: torch.Generator, x01: torch.Tensor, family: torch.Tensor, rows: int,
                  experts: int, device) -> List[Dict[str, torch.Tensor]]:
    """One CDAN a family, calibrated on the first ``rows`` of its own rows."""
    return [calibrated_state(gen, x01[family == e][:rows], device) for e in range(experts)]


def write_files(directory: str, experts: Sequence[Dict[str, torch.Tensor]],
                names: Sequence[str], classifier: Dict[str, torch.Tensor]) -> str:
    """The files the program's CLI reads, by the program's own writers:
    ``CDAN_<name>.pt`` for each expert (``engine.checkpoint.save_weights``)
    and ``classifier.pt`` with its ``.json`` of ``classes`` in ``names``'
    order (``classification.train.save_checkpoint``); returns the
    classifier's path.  No ``thresholds_val.json``: the CLI takes its
    packaged thresholds."""
    from multi_degradation_image_enhancement_tpu_torch.classification.train import save_checkpoint
    from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import save_weights
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN

    os.makedirs(directory, exist_ok=True)
    for name, state in zip(names, experts):
        model = CDAN()
        model.load_state_dict({k: v.detach().float().cpu() for k, v in state.items()})
        save_weights(os.path.join(directory, f"CDAN_{name}.pt"), model)
    path = os.path.join(directory, "classifier.pt")
    save_checkpoint(path, _classifier_module(classifier), {"classes": list(names)})
    return path
