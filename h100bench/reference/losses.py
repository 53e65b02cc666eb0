"""The recipes' loss terms in plain PyTorch float32, NHWC images in [0, 1].

* ``charbonnier``: mean √(d² + ε²), ε from the term's ``eps`` (1e-3);
* ``l1``: mean |d|;
* ``ssim``: 1 − SSIM with torchmetrics' semantics: an 11-tap Gaussian
  window (σ 1.5), valid windows only, k1 0.01, k2 0.03, the data range
  max(max p − min p, max t − min t), the mean over batch, channels and
  positions;
* ``vgg_perceptual``: the mean squared difference of VGG19 ``features[:20]``
  (torchvision's layout: 3×3 convs, ReLUs, 2×2 max-pools; the last op the
  conv at index 19, without its ReLU), the targets' features without a graph;
* ``lpips``: LPIPS with the AlexNet backbone as torchmetrics computes it on
  [0, 1] images: the shift/scale prep, the five ReLU taps of
  ``alexnet().features``, each unit-normalised over channels (1e-10 under the
  root), the squared difference weighted by |lin|, the spatial mean, the sum
  over taps; the batch mean of the per-image distances.

The frozen networks' weights come from the harness as tensors in torch's
layouts: ``vgg.conv_{i}.weight`` / ``.bias``; ``alex.conv_{i}.weight`` /
``.bias`` and ``alex.lin_{k}`` ``[C, 1]``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

# torchvision vgg19().features[:20]: conv (out channels) or "relu" / "pool"
VGG19_20: Tuple = (64, "relu", 64, "relu", "pool", 128, "relu", 128, "relu", "pool",
                   256, "relu", 256, "relu", 256, "relu", 256, "relu", "pool", 512)
# torchvision alexnet().features: (index, c_in, c_out, kernel, stride, padding)
ALEX_CONVS: Tuple = ((0, 3, 64, 11, 4, 2), (3, 64, 192, 5, 1, 2), (6, 192, 384, 3, 1, 1),
                     (8, 384, 256, 3, 1, 1), (10, 256, 256, 3, 1, 1))
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def vgg19_features(x_nhwc: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    x = x_nhwc.permute(0, 3, 1, 2)
    for i, op in enumerate(VGG19_20):
        if op == "relu":
            x = torch.relu(x)
        elif op == "pool":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.conv2d(x, w[f"vgg.conv_{i}.weight"], w[f"vgg.conv_{i}.bias"], padding=1)
    return x


def alex_taps(x_nchw: torch.Tensor, w: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    def conv(t, i, stride, pad):
        return torch.relu(F.conv2d(t, w[f"alex.conv_{i}.weight"], w[f"alex.conv_{i}.bias"],
                                   stride=stride, padding=pad))

    t0 = conv(x_nchw, 0, 4, 2)
    t1 = conv(F.max_pool2d(t0, 3, 2), 3, 1, 2)
    t2 = conv(F.max_pool2d(t1, 3, 2), 6, 1, 1)
    t3 = conv(t2, 8, 1, 1)
    t4 = conv(t3, 10, 1, 1)
    return [t0, t1, t2, t3, t4]


def lpips_alex(x_nhwc, y_nhwc, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-image LPIPS distances ``[B]``."""
    shift = torch.tensor(LPIPS_SHIFT, device=x_nhwc.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, device=x_nhwc.device).reshape(1, 3, 1, 1)

    def taps(img):
        return alex_taps((img.permute(0, 3, 1, 2) - shift) / scale, w)

    total = 0.0
    for k, (a, b) in enumerate(zip(taps(x_nhwc), taps(y_nhwc))):
        na = a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
        nb = b / torch.sqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
        lin = w[f"alex.lin_{k}"].abs().reshape(1, -1, 1, 1)
        total = total + ((na - nb) ** 2 * lin).sum(dim=1).mean(dim=(1, 2))
    return total


def ssim(p: torch.Tensor, t: torch.Tensor, size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    dr = torch.maximum(p.amax() - p.amin(), t.amax() - t.amin())
    c1, c2 = (k1 * dr) ** 2, (k2 * dr) ** 2
    ax = torch.arange(size, dtype=p.dtype, device=p.device) - (size - 1) / 2.0
    g = torch.exp(-(ax * ax) / (2.0 * sigma * sigma))
    g = g / g.sum()
    c = p.shape[-1]
    kh = g.reshape(1, 1, size, 1).repeat(c, 1, 1, 1)
    kw = g.reshape(1, 1, 1, size).repeat(c, 1, 1, 1)

    def blur(v):  # valid-mode separable Gaussian, per channel
        v = v.permute(0, 3, 1, 2)
        return F.conv2d(F.conv2d(v, kh, groups=c), kw, groups=c)

    mx, my = blur(p), blur(t)
    sxx, syy, sxy = blur(p * p) - mx * mx, blur(t * t) - my * my, blur(p * t) - mx * my
    num = (2.0 * mx * my + c1) * (2.0 * sxy + c2)
    den = (mx * mx + my * my + c1) * (sxx + syy + c2)
    return (num / den).mean()


def recipe_loss(terms: List[dict], out, target, perceptual: Dict[str, torch.Tensor]):
    """(total, {term: value}) of a recipe's ``loss.terms`` on NHWC images."""
    parts = {}
    total = torch.zeros((), dtype=torch.float32, device=out.device)
    for term in terms:
        name, args = term["name"], term.get("args") or {}
        d = out - target
        if name == "charbonnier":
            eps = float(args.get("eps", 1e-3))
            v = torch.sqrt(d * d + eps * eps).mean()
        elif name == "l1":
            v = d.abs().mean()
        elif name == "ssim":
            v = 1.0 - ssim(out, target)
        elif name == "vgg_perceptual":
            if int(args.get("layers", 20)) != 20:
                raise ValueError("the reference holds VGG19 features[:20] only")
            with torch.no_grad():
                ft = vgg19_features(target, perceptual)
            v = ((vgg19_features(out, perceptual) - ft) ** 2).mean()
        elif name == "lpips":
            if args.get("net", args.get("net_type", "alex")) != "alex":
                raise ValueError("the reference holds LPIPS-alex only")
            v = lpips_alex(out, target, perceptual).mean()
        else:
            raise ValueError(f"the reference has no loss term {name!r}")
        parts[name] = v
        total = total + float(term.get("weight", 1.0)) * v
    return total, parts
