#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (needs one NVIDIA Hopper GPU).

    python3 chip_smoke.py

Drives ``multi_degradation_image_enhancement_tpu_torch`` on the card, one
line per phase, and exits non-zero at the first failure:

1. device: capability (9, 0), the card's name and power limit, TF32 off;
2. build: compiles ``csrc/*.cu`` with nvcc (sm_90a) into ``build/torch_kernels``;
3. noise kernel vs its plain version on the kernel's own Philox bits (the
   contract of tests/test_noise_kernel.py at B=4·64×256, then the serving
   shapes);
4. DenseBlock kernel (bf16) vs its plain version (f32) at the eight block
   shapes of the B=128·256² and B=16·256×384 forwards;
5. the bf16 serving forward with kernels vs the canonical f32 ``CDAN``;
6. requests through ``serving.build_pipeline`` (B=128·256², then
   B=16·256×384), with launch counters showing both kernels ran;
7. times (CUDA events): ms/step, img/s, each kernel beside its plain version.

The last three lines are the ``nvidia-smi`` name/power-limit line, a JSON
object with one entry per kernel, and ``{"ok": true, "device": {...}}``.
Weights are random (seeded); no trained checkpoint is needed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PKG = "multi_degradation_image_enhancement_tpu_torch"
BENCH_BATCH, BENCH_SIZE = 128, 256
EVAL_BATCH, EVAL_HW = 16, (256, 384)
BENCH_STEPS, EVAL_STEPS = 5, 3
# (block, batch, c_in, (H, W)) as the serving step gives them at the bench
# (B=128·256²) and eval (B=16·256×384) shapes.
DB_SHAPES = [
    ("dense1", BENCH_BATCH, 64, (128, 128)), ("dense2", BENCH_BATCH, 128, (64, 64)),
    ("dense3", BENCH_BATCH, 256, (32, 32)), ("final_dense", BENCH_BATCH, 3, (256, 256)),
    ("dense1", EVAL_BATCH, 64, (128, 192)), ("dense2", EVAL_BATCH, 128, (64, 96)),
    ("dense3", EVAL_BATCH, 256, (32, 48)), ("final_dense", EVAL_BATCH, 3, (256, 384)),
]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device(torch):
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"compute capability (9, 0) (Hopper), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    # The f32 plain versions are the oracles: keep cuDNN and matmuls in full f32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("device", f"{torch.cuda.get_device_name(0)} cap={cap} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    say("device", f"nvidia-smi: {smi}")
    say("device", f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build():
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    lib_path, nvcc_seconds, log = _build.build()
    _build.load()
    say("build", f"{lib_path} nvcc {nvcc_seconds:.1f} s, load total "
        f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("build", line.strip())


def noise_vs_plain(torch, noise, clean, std, seed, out_dtype) -> float:
    """Kernel vs ``bits_to_noise01`` on the kernel's own Philox words: at most
    0.1% of elements differ, each by at most one u8 level (plus one bf16 ulp
    at 1.0 for bf16 output).  Returns the max abs error."""
    b = clean.shape[0]
    n_pairs = clean[0].numel() // 2
    bits1, bits2 = noise.philox_bits(seed, b, n_pairs, clean.device)
    ref1, ref2 = noise.philox_bits_plain(seed, b, n_pairs, clean.device)
    require(torch.equal(bits1, ref1) and torch.equal(bits2, ref2),
            "kernel Philox words == plain Philox words")
    plain = noise.bits_to_noise01(bits1, bits2, clean, std, 1.0 / 255.0).to(out_dtype)
    out = noise.noise_degrade_01(clean, std, seed, out_dtype=out_dtype)
    torch.cuda.synchronize()
    require(out.dtype == out_dtype and out.shape == clean.shape, "noise output dtype/shape")
    diff = (out.float() - plain.float()).abs()
    share = (diff > 0).float().mean().item()
    max_err = diff.max().item()
    tol = 1.0 / 255.0 + (2.0**-8 if out_dtype == torch.bfloat16 else 1e-6)
    say("noise", f"{tuple(clean.shape)} {out_dtype}: mismatch share {share:.3e} (limit 1e-3), "
        f"max abs err {max_err:.3e} (limit {tol:.3e})")
    require(share <= 1e-3, "noise kernel agrees with plain on >= 99.9% of elements")
    require(max_err <= tol, "noise mismatches are within one u8 level")
    return max_err


def phase_noise(torch):
    from multi_degradation_image_enhancement_tpu_torch import serving
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda import noise

    dev = torch.device("cuda")
    b, h, w = 4, 64, 256
    g = torch.Generator(device=dev).manual_seed(7)
    clean = torch.empty((b, h, w, 3), device=dev).uniform_(60.0, 200.0, generator=g)
    std = torch.tensor([10.0, 20.0, 30.0, 50.0], device=dev)
    seed = 1234
    worst = max(noise_vs_plain(torch, noise, clean, std, seed, dt)
                for dt in (torch.float32, torch.bfloat16))
    for bsz, (h2, w2) in ((BENCH_BATCH, (BENCH_SIZE, BENCH_SIZE)), (EVAL_BATCH, EVAL_HW)):
        std2 = noise.sample_sigma(torch.Generator(device=dev).manual_seed(bsz), bsz)
        worst = max(worst, noise_vs_plain(torch, noise, serving.clean_batch(bsz, h2, w2, dev),
                                          std2, 4321, torch.bfloat16))
    out1 = noise.noise_degrade_01(clean, std, seed)
    out2 = noise.noise_degrade_01(clean, std, seed)
    out3 = noise.noise_degrade_01(clean, std, 99)
    require(torch.equal(out1, out2), "same seed gives an identical stream")
    require((out1 - out3).abs().max().item() > 0, "another seed gives another stream")
    require(out1.min().item() >= 0.0 and out1.max().item() <= 1.0, "noise output in [0, 1]")
    resid = out1 * 255.0 - torch.floor(torch.clamp(clean, 0, 255))
    sig = resid.reshape(b, -1).std(dim=1)
    for i in range(b):
        rel = abs(sig[i].item() - std[i].item()) / std[i].item()
        require(rel < 0.05, f"image {i}: noise σ {sig[i].item():.3f} within 5% of {std[i].item()}")
    require((resid[0] - resid[1]).abs().max().item() > 1.0, "images do not share a stream")
    say("noise", f"σ per image {[round(s, 3) for s in sig.tolist()]} vs {std.tolist()}; "
        "deterministic per seed, distinct per seed and per image")
    return worst


def phase_dense_blocks(torch, model):
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        dense_block, dense_block_plain, pack_dense_block,
    )

    dev = torch.device("cuda")
    blocks = {"dense1": model.encoder.dense1, "dense2": model.encoder.dense2,
              "dense3": model.encoder.dense3, "final_dense": model.decoder.final_dense}
    packs = {name: pack_dense_block(block, dev) for name, block in blocks.items()}
    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for name, bsz, c_in, (h, w) in DB_SHAPES:
        x = torch.rand((bsz, c_in, h, w), device=dev, generator=g).to(torch.bfloat16)
        got = dense_block(x, packs[name])
        ref = dense_block_plain(x.float(), packs[name])
        ref_bf16 = dense_block_plain(x, packs[name])
        torch.cuda.synchronize()
        require(got.dtype == torch.bfloat16 and got.shape == x.shape, f"{name} output dtype/shape")
        err = (got.float() - ref).abs()
        err16 = (got.float() - ref_bf16.float()).abs().max().item()
        worst = max(worst, err.max().item())
        say("dense_block", f"{name} B={bsz} c={c_in} {h}x{w}: max {err.max().item():.3e} (limit 5e-2) "
            f"mean {err.mean().item():.3e} (limit 5e-3); vs plain-bf16 max {err16:.3e}")
        require(err.max().item() <= 5e-2 and err.mean().item() <= 5e-3,
                f"{name} {h}x{w} kernel vs plain")
    # f32 in/out through the same kernels (features still held in bf16).
    x = torch.rand((2, 64, 32, 48), device=dev, generator=g)
    err = (dense_block(x, packs["dense1"]) - dense_block_plain(x, packs["dense1"])).abs()
    say("dense_block", f"dense1 f32 I/O 32x48: max {err.max().item():.3e} mean "
        f"{err.mean().item():.3e}")
    require(err.max().item() <= 5e-2 and err.mean().item() <= 5e-3, "f32 I/O kernel vs plain")
    return worst, packs


def phase_forward(torch, model):
    from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply

    dev = torch.device("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == 3_585_663, f"CDAN has 3,585,663 parameters, got {n_params}")
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((2, *EVAL_HW, 3), device=dev, generator=g)
    model = model.to(dev)
    with torch.inference_mode():
        ref = model(x)
        got = build_serving_apply(model, torch.bfloat16, dev)(x)
    torch.cuda.synchronize()
    require(got.shape == ref.shape and got.dtype == torch.float32, "forward shape/dtype")
    err = (got - ref).abs()
    say("forward", f"{n_params} params; bf16 kernels vs f32 CDAN at 2x{EVAL_HW[0]}x{EVAL_HW[1]}: "
        f"max {err.max().item():.3e} (limit 2e-2) mean {err.mean().item():.3e} (limit 2e-3)")
    require(err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, "serving forward vs module")


def phase_requests(torch):
    from multi_degradation_image_enhancement_tpu_torch import serving
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import dense_block
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import noise_degrade_01

    step, bench_clean = serving.build_pipeline(BENCH_BATCH, BENCH_SIZE, torch.bfloat16, "cuda")
    eval_clean = serving.clean_batch(EVAL_BATCH, *EVAL_HW, device="cuda")
    gen = torch.Generator().manual_seed(1)
    step(bench_clean, gen)  # warm-up (cuDNN algorithm choice)
    step(eval_clean, gen)
    torch.cuda.synchronize()

    noise_degrade_01.launches = 0
    dense_block.launches = 0
    outs = [step(bench_clean, gen) for _ in range(BENCH_STEPS)]
    outs += [step(eval_clean, gen) for _ in range(EVAL_STEPS)]
    torch.cuda.synchronize()
    launches = {"noise_degrade": noise_degrade_01.launches, "dense_block": dense_block.launches}

    n_steps = BENCH_STEPS + EVAL_STEPS
    for i, out in enumerate(outs):
        bsz, hw = (BENCH_BATCH, (BENCH_SIZE, BENCH_SIZE)) if i < BENCH_STEPS else (EVAL_BATCH, EVAL_HW)
        require(tuple(out.shape) == (bsz, *hw, 3) and out.dtype == torch.float32, "output shape")
        require(bool(torch.isfinite(out).all()), "outputs finite")
        require(out.min().item() >= 0.0 and out.max().item() <= 1.0, "outputs in [0, 1]")
    say("requests", f"{BENCH_STEPS} steps B={BENCH_BATCH}x{BENCH_SIZE}^2 + {EVAL_STEPS} steps "
        f"B={EVAL_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} bf16: finite, in [0,1]; launches {launches} "
        f"(expected noise {n_steps}, dense_block {20 * n_steps})")
    require(launches["noise_degrade"] == n_steps, "one noise launch per step")
    require(launches["dense_block"] == 20 * n_steps,
            "4 DenseBlocks x (4 growth + 1 transition) launches per step")
    return launches, step, bench_clean, eval_clean


def phase_times(torch, smi, step, bench_clean, eval_clean, packs):
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda import noise
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        dense_block, dense_block_plain,
    )

    gen = torch.Generator().manual_seed(2)
    step_ms = cuda_ms(lambda: step(bench_clean, gen), reps=10)
    eval_ms = cuda_ms(lambda: step(eval_clean, gen), reps=10)
    say("times", f"[{smi}] degrade->restore B={BENCH_BATCH}x{BENCH_SIZE}^2 bf16: {step_ms:.3f} "
        f"ms/step, {BENCH_BATCH / step_ms * 1e3:.1f} img/s; eval shape "
        f"B={EVAL_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]}: {eval_ms:.3f} ms/step")

    std = torch.linspace(10.0, 50.0, BENCH_BATCH, device="cuda")
    times = {
        "noise_degrade": (
            cuda_ms(lambda: noise.noise_degrade_01(bench_clean, std, 11, out_dtype=torch.bfloat16), 20),
            cuda_ms(lambda: noise.noise_degrade_01_plain(
                bench_clean, std, 11, out_dtype=torch.bfloat16), 5),
        )
    }
    g = torch.Generator(device="cuda").manual_seed(4)
    db_ms = db_plain_ms = 0.0
    for name, bsz, c_in, (h, w) in DB_SHAPES[:4]:
        x = torch.rand((bsz, c_in, h, w), device="cuda", generator=g).to(torch.bfloat16)
        k_ms = cuda_ms(lambda: dense_block(x, packs[name]), 10)
        p_ms = cuda_ms(lambda: dense_block_plain(x, packs[name]), 5)
        db_ms += k_ms
        db_plain_ms += p_ms
        say("times", f"[{smi}] dense_block {name} B={bsz} c={c_in} {h}x{w} bf16: "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    times["dense_block"] = (db_ms, db_plain_ms)
    say("times", f"[{smi}] noise_degrade B={BENCH_BATCH}x{BENCH_SIZE}^2 bf16 out: kernel "
        f"{times['noise_degrade'][0]:.3f} ms, plain {times['noise_degrade'][1]:.3f} ms; "
        f"dense_block x4 per step: kernel {db_ms:.3f} ms, plain {db_plain_ms:.3f} ms")
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        __import__(PKG)
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan

    smi = phase_device(torch)
    phase_build()
    noise_err = phase_noise(torch)
    model = init_cdan(torch.Generator().manual_seed(0))
    db_err, packs = phase_dense_blocks(torch, model)
    phase_forward(torch, model)
    launches, step, bench_clean, eval_clean = phase_requests(torch)
    times = phase_times(torch, smi, step, bench_clean, eval_clean, packs)

    src = f"{PKG}/csrc"
    ref = "multi_degradation_image_enhancement_tpu/ops/pallas"
    kernels = [
        {"name": "noise_degrade", "route": "cuda", "source": f"{src}/noise.cu",
         "replaces": f"{ref}/noise.py:75", "launches": launches["noise_degrade"],
         "max_abs_err": noise_err, "ms": times["noise_degrade"][0],
         "plain_ms": times["noise_degrade"][1]},
        {"name": "dense_block", "route": "cuda", "source": f"{src}/dense_block.cu",
         "replaces": f"{ref}/dense_block_cm.py:452", "launches": launches["dense_block"],
         "max_abs_err": db_err, "ms": times["dense_block"][0],
         "plain_ms": times["dense_block"][1]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
