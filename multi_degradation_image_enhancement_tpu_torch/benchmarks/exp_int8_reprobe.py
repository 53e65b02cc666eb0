"""The int8 / bf16 GEMM throughput probe on the card (counterpart of
``benchmarks/exp_int8_reprobe.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.exp_int8_reprobe [--iters 20]
    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.exp_int8_reprobe --profile

Times the hand-written batched GEMM (``ops.cuda.probe_matmul``, TPU kernel
#11) on the probe's 32 blocks of [1536,512]×[512,2048], bf16 → f32 → bf16
and int8 → i32 → i32, beside the library's own call (``torch.bmm`` in bf16,
``torch._int_mm`` per block for int8, which has no batched form), by CUDA
events, and prints ms and T(FL)OP/s for each.  The operands are seeded
random values (the JAX probe's ones would hide a wrong index).  With
``--profile`` it prints instead, from ``torch.profiler`` over ``--iters``
int8 calls in a fresh process, the device ms a call of each of the int8
call's two launches: the K-major pass of b and the GEMM.
"""

from __future__ import annotations

import argparse

import torch

from multi_degradation_image_enhancement_tpu_torch.benchmarks import cuda_ms, require_cuda
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_matmul import probe_matmul

M, K, N, BLOCKS = 1536, 512, 2048, 32
FLOPS = 2 * M * K * N * BLOCKS
DTYPES = {"bf16->f32": torch.bfloat16, "int8->i32": torch.int8}


def make_operands(dtype: torch.dtype, device="cuda", seed: int = 0):
    """Seeded ``a`` [BLOCKS, M, K] and ``b`` [BLOCKS, K, N]: int8 uniform over
    [-128, 127], bf16 uniform over [0, 1) (positive, so no output cancels and
    a bf16 result is within an ulp of the f32 sum)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.int8:
        def draw(shape):
            return torch.randint(-128, 128, shape, generator=g, device=device, dtype=torch.int8)
    else:
        def draw(shape):
            return torch.rand(shape, generator=g, device=device).to(dtype)
    return draw((BLOCKS, M, K)), draw((BLOCKS, K, N))


def library_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The library's call for the same function (a yardstick, used nowhere in
    the port): ``torch.bmm`` in bf16; ``torch._int_mm`` block by block for int8."""
    if a.dtype == torch.int8:
        return torch.stack([torch._int_mm(a[i], b[i]) for i in range(a.shape[0])])
    return torch.bmm(a, b)


def run(iters: int = 20) -> dict:
    """Kernel and library ms for both type sets, printed and returned as
    ``{label: {"kernel_ms", "library_ms" (None if the call failed),
    "launches" (of the kernel for this label)}}``."""
    require_cuda()
    rows = {}
    for label, dtype in DTYPES.items():
        a, b = make_operands(dtype)
        n0 = probe_matmul.launches
        k_ms = cuda_ms(lambda: probe_matmul(a, b), iters)
        launches = probe_matmul.launches - n0
        print(f"kernel  {label}: {k_ms:8.3f} ms  {FLOPS / k_ms / 1e9:7.1f} T(FL)OP/s", flush=True)
        try:
            lib_ms = cuda_ms(lambda: library_matmul(a, b), iters)
            print(f"library {label}: {lib_ms:8.3f} ms  {FLOPS / lib_ms / 1e9:7.1f} T(FL)OP/s",
                  flush=True)
        except RuntimeError as e:  # a yardstick the installed library lacks
            lib_ms = None
            print(f"library {label}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)
        rows[label] = {"kernel_ms": k_ms, "library_ms": lib_ms, "launches": launches}
        del a, b
    return rows


def profile_int8(iters: int = 20) -> dict:
    """Device ms a call of each kernel of the int8 call, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    require_cuda()
    a, b = make_operands(torch.int8)
    probe_matmul(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            probe_matmul(a, b)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us and str(e.device_type).endswith("CUDA"):
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            ms[name] = ms.get(name, 0.0) + us / 1e3 / iters
    for name, t in ms.items():
        print(f"profile int8->i32 {name}: {t:8.4f} ms a call", flush=True)
    return ms


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="the device ms of the int8 call's two launches instead")
    args = ap.parse_args()
    (profile_int8 if args.profile else run)(args.iters)


if __name__ == "__main__":
    main()
