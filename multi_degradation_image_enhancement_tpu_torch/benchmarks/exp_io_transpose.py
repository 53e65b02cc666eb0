"""The transpose probe on the card (counterpart of
``benchmarks/exp_io_transpose.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.exp_io_transpose [--iters 20]

On the probe's inputs (B=128 images of P=128·128 pixels, C=64 channels;
``x = arange·1e-4`` in bf16, ``M = I``) it checks and times the three
hand-written kernels of ``ops.cuda.probe_transpose`` (TPU kernels #12–#14):
``M · xᵀ`` ([P,C]→[C,P]), ``xᵀ · M`` ([C,P]→[P,C]) and the tiled transpose.
Beside them, the JAX probe's two baselines: the library's transpose
(``.transpose(1, 2).contiguous()``) and a copy (``x + 1``) as the bandwidth
reference.  ``ok=`` is the JAX probe's check (image 3 against its
transpose, atol 1e-3); times are CUDA-event means in ms.
"""

from __future__ import annotations

import argparse

import torch

from multi_degradation_image_enhancement_tpu_torch.benchmarks import cuda_ms, require_cuda
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_transpose import (
    m_dot_xt,
    transpose,
    xt_dot_m,
)

B, H, W, C = 128, 128, 128, 64
P = H * W


def probe_inputs(device="cuda"):
    """``x`` [B, P, C] = arange·1e-4 in bf16 and ``M = I`` [C, C] (exp_io_transpose.py:65-68)."""
    x = torch.arange(B * P * C, dtype=torch.int32, device=device).to(torch.bfloat16)
    return x.reshape(B, P, C) * 1e-4, torch.eye(C, dtype=torch.bfloat16, device=device)


def run(iters: int = 20) -> dict:
    """Check and time each route; returns ``{route: {"ok", "ms"}}`` (``ok``
    None for the baselines)."""
    require_cuda()
    x, eye = probe_inputs()
    xc = x.transpose(1, 2).contiguous()
    rows = {}
    for route, fn, src in (("rhsT identity-dot", lambda: m_dot_xt(x, eye), x),
                           ("lhsT identity-dot", lambda: xt_dot_m(xc, eye), xc),
                           ("in-kernel .T", lambda: transpose(x), x)):
        y = fn()
        ok = bool(torch.allclose(y[3].float(), src[3].T.float(), atol=1e-3))
        ms = cuda_ms(fn, iters)
        print(f"{route:18s}: ok={ok}  {ms:.3f} ms", flush=True)
        rows[route] = {"ok": ok, "ms": ms}
    for route, fn in (("library transpose", lambda: x.transpose(1, 2).contiguous()),
                      ("copy (bw ref)", lambda: x + 1)):
        ms = cuda_ms(fn, iters)
        print(f"{route:18s}: {ms:.3f} ms", flush=True)
        rows[route] = {"ok": None, "ms": ms}
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    run(ap.parse_args().iters)


if __name__ == "__main__":
    main()
