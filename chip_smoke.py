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
4. DenseBlock kernels (bf16) vs their plain version (f32) at the eight block
   shapes of the B=128·256² and B=16·256×384 forwards, a ragged B=1 33×47
   image, growth 12, f32 I/O and both NHWC entries (#3's and #10's);
5. the bf16 serving forward with kernels vs the canonical f32 ``CDAN``;
6. requests through ``serving.build_pipeline`` (B=128·256², then
   B=16·256×384), with launch counters showing both kernels ran;
7. times (CUDA events): ms/step, img/s, each kernel beside its plain version;
   each DenseBlock at B=128·256² also beside the module route (the unfused
   ``models.cdan.DenseBlock`` under a bf16 autocast) and the bytes floor of
   the kernels' per-layer design; then ``torch.profiler`` over 5 serving
   steps: busy share and the shares of the DenseBlock's kernels, the
   upsample, the convolutions and the glue;
8. growth-train kernels (forward and backward) vs their plain version at the
   16 layer shapes of a B=16·256×384 train step and at B=1 33×47 with c = 19
   and 72 (ragged tiles), f32 I/O, the backward repeated bit for bit;
9. a whole fp32 train step at 2×256×384, growth kernels vs plain: loss,
   running statistics, every gradient leaf;
10. training through the CLI (``run.main`` on noise_synthetic.json cut to one
    epoch of 64 images, bf16, fused DenseBlocks, BN recalibration), with the
    growth launch counters reset before it and read after;
11. times: ms per bf16 train step and img/s; growth forward and backward per
    step, kernel vs its bound, plain and the module route (the unfused BN ->
    ReLU -> conv layer under a bf16 autocast, cuDNN);
12. conv kernels vs their plain versions, TF32 off: conv+pool (#9) at conv1
    of B=128·256² and B=16·256×384, at 8 -> 16 and 64 -> 128 channels
    (B=3, 16×32), at a ragged 10×18 and with an f32 x; conv (#8) at the
    seven CM conv shapes of B=128·256² and of B=16·256×384, at c_in 72 /
    c_out 3, at 32×34 and with an f32 x;
13. the bf16 all-channel-major forward vs the f32 ``CDAN`` at 2×256² and
    2×256×384, with the default conv table and with every conv on #8;
14. the DenseBlock kernel at the block shapes where the JAX package takes
    its row-tiled kernel (#3), ``fused_dense_block_cm`` once, and the
    per-block forward at 2×480×640 vs the f32 ``CDAN``;
15. serving steps with ``prefer_cm`` at B=128·256², first with the default
    conv table, then with every conv on #8, with launch counters;
16. ``run.main`` ``-p test`` on noise_synthetic.json's test block cut to 64
    images, scoring the checkpoint of phase 10: as shipped, with
    ``MDIE_SERVING_TUNING`` naming a tuning copy with ``prefer_cm: true``,
    and with the test images resized to 480×640 (the #3 route);
17. times: #8 and #9 vs plain, #9 also vs its cuDNN module route (bf16
    ``F.conv2d`` + bias, ReLU, ``F.max_pool2d``: a yardstick the port never
    calls), the CM vs the per-block forward, the eval step per B=16 batch,
    the whole ``-p test``;
18. ``fused_dense_block`` (#10's entry) vs its plain version at the four
    block shapes of the B=16·256×384 forward, f32 and bf16 x,
    ``LAUNCHES_PER_BLOCK`` (6) launches a call (entry pass, 4 growth layers,
    transition); then its public entry on those four blocks with the counter
    reset;
    its time beside ``fused_dense_block_cm`` and plain;
19. the nine degradations at B=16·256×384 on the card vs the same function
    on the CPU with the same explicit parameters, with TF32 at PyTorch's
    defaults (as the CLI leaves them), and each one's ms per batch;
20. ``run.main`` on jpeg_synthetic, low_light_synthetic and
    pixelation_hard_synthetic: one epoch of 64 images, then ``-p test`` on 64
    test images (low_light's POST stage: ``post`` row, ``pp_*`` PNGs), with
    the growth-train and DenseBlock counters reset before each run and read
    after;
21. times: jpeg_synthetic's bf16 train step with and without its perceptual
    terms (VGG19 + LPIPS), beside noise's (TF32 off); then ``torch.profiler``
    over three steps of noise_synthetic and of jpeg_synthetic: device time,
    busy share, the growth-train kernels' time and share, the ten costliest
    kernels; all with TF32 at PyTorch's defaults, as the CLI trains;
22. per kernel, the least time the card could take for the work timed
    (beside its time, plain version and, for #2 and #4–#7, the module route)
    (``bound_ms``: FLOPs over 989 TFLOP/s bf16, 1979 TOP/s int8, or 67
    TFLOP/s f32 for elementwise work, against bytes over 3.35 TB/s, the
    larger) and, where one PyTorch call computes the same function, that
    call's time;
23. the probe kernels #11-#14 (``ops.cuda.probe_matmul``,
    ``ops.cuda.probe_transpose``) at the probes' shapes vs their plain
    versions, #12/#13 also at ragged P and above the 65535 grid cap, then
    the two probe scripts (``benchmarks/exp_int8_reprobe.py``,
    ``exp_io_transpose.py``) with the launch counters reset: kernel, plain
    and library ms, and for #12/#13 the bound and the probe's copy time;
24. the routed serving pipeline: nine full-width experts, a full-width
    ResNet-18 classifier and 64 degraded PNGs at 256x384 written to
    ``build/chip_smoke_pipeline/``; the CLI ``run_pipeline`` in top1 and
    severity-ordered sequential mode (B=32), in-process with the counts
    reset around it and as a subprocess; its PNGs against an in-process
    ``FullPipeline`` (1 LSB), no DenseBlock launch (the experts run the eval
    module under a bf16 autocast, the JAX pipeline's route), the three top1
    cases (routed, clean, dropped), the step's times and drop rate with each
    image routed by its own degradation, and one expert's module and fused
    routes against the f32 module;
25. classifier training on the card: 24 procedural PNGs of odd sizes
    letterboxed by ``datasets_generation.generate_classifier`` (on the card),
    then ``classification.train --dataset_root … --no_pretrained`` for one
    epoch at B=32·256x384 through all four stages; then ``--synthetic`` at
    ``CLF_SYNTH``'s scale for each of ``CLF_SEEDS``, each gated on
    tests/test_classifier_quality.py's floors (val F1-micro ≥ 0.35 with tuned
    thresholds, test ≥ 0.30, severity MAE ≤ 0.30);
26. times: the classifier's f32 train step at B=32·256x384 (20 steps after
    warm-up, CUDA events), its eval step, and the synthetic degrade stage of
    one template batch; ``torch.profiler`` over three train steps (busy
    share, convolutions and GEMMs against the rest, the costliest kernels);
27. the trained head (phase 25, first seed) in the routed server: the CLI
    ``run_pipeline`` on phase 24's 64 PNGs and experts; top-1 route accuracy
    against each PNG's degradation and the top1 drop rate, reported, not
    gated (no pretrained backbone);
28. a directory config: ``datasets_generation.generate_paired`` writes noise
    pairs of 64 procedural PNGs on the card, then ``run.main`` ``-p train``
    (one epoch of ``config/noise.json`` with its roots rewritten, bf16, fused
    DenseBlocks) and ``-p test``, with the growth-train (#4–#7) and DenseBlock
    (#2) launches counted; train and test step img/s.

Phases 5, 12-14, 17 and 24 use CDANs whose BatchNorm statistics keep the whole path
live (``live_cdan``): with ``init_cdan``'s statistics the decoder's ReLUs
pass nothing but the global residual.

Phases 19, 21, 25, 26 and 28 run with ``cudnn.allow_tf32`` True and
``matmul.allow_tf32`` False (PyTorch's defaults, as the CLIs leave them) and
turn both off again after them.

The last three lines are the ``nvidia-smi`` name/power-limit line, a JSON
object with one entry per kernel, and ``{"ok": true, "device": {...}}``.
Weights are random (seeded); no trained checkpoint is needed.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PKG = "multi_degradation_image_enhancement_tpu_torch"
BENCH_BATCH, BENCH_SIZE = 128, 256
EVAL_BATCH, EVAL_HW = 16, (256, 384)
TRAIN_BATCH = 16
CLI_IMAGES = 64  # one epoch = four train steps at B=16
CONFIG_DIR = Path("multi_degradation_image_enhancement_tpu") / "config"
CONFIG = CONFIG_DIR / "noise_synthetic.json"
# the configs phase 20 trains and scores: every new loss term, transform and the POST stage
CLI_TASKS = ("jpeg_synthetic", "low_light_synthetic", "pixelation_hard_synthetic")
# H100 SXM published peaks (dense): bf16 and int8 tensor cores, f32 outside them, HBM3
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# (block, c_in, (H, W)) of the four DenseBlocks of a B=16·256×384 train step;
# layer i of a block reads c_in + 16·i channels.
GT_BLOCKS = [("dense1", 64, (128, 192)), ("dense2", 128, (64, 96)),
             ("dense3", 256, (32, 48)), ("final_dense", 3, (256, 384))]
# (batch, c, (H, W)) of phase 8's ragged growth layers: tiles cut at the edges,
# c within one backward chunk (19) and past it (72)
GT_RAGGED = [(1, 19, (33, 47)), (1, 72, (33, 47))]
BENCH_STEPS, EVAL_STEPS = 5, 3
TEST_IMAGES = 64  # the -p test phases score 64 of the test block's 128 images
PHOTO_HW, PHOTO_IMAGES = (480, 640), 32  # a size where the JAX package takes _run_cm (#3)
PROBE_ITERS = 20  # timed calls of each route in the probe scripts (phase 23)
# (batch, P) of #12/#13's extra checks: ragged last tiles (1000 = 7 * 128 + 104;
# 40 leaves a 64-pixel box wholly past P) and a batch above the 65535 grid cap
RAGGED_PRODUCTS = ((3, 1000), (5, 40), (65537, 8))
PIPE_IMAGES, PIPE_BATCH = 64, 32  # the routed pipeline's directory and batch (phase 24)
CLF_CLEAN, CLF_BATCH = 24, 32  # phase 25's clean PNGs and its classifier batch (256x384)
# phase 25's --synthetic runs: the scale that cleared tests/test_classifier_quality.py's
# floors on each of the three seeds on the card (PERF.md section 4, the classifier shape)
CLF_SYNTH = {"images": 96, "variants": 2, "epochs": 6, "batch": 32, "hw": EVAL_HW}
CLF_SEEDS = (42, 43, 44)
CLF_FLOORS = {"val_f1_micro": 0.35, "test_f1_micro": 0.30, "sev_mae": 0.30}
DIR_IMAGES = 64  # phase 28's clean PNGs: 54 train and 10 test pairs
# (layer, c_in, c_out, (H, W)) of the CM forward's 3x3 convs at B=128·256².
CM_CONVS = [("conv2", 64, 128, (128, 128)), ("conv3", 128, 256, (64, 64)),
            ("conv4", 256, 512, (32, 32)), ("de1", 512, 256, (32, 32)),
            ("de2", 256, 128, (32, 32)), ("de3", 128, 64, (64, 64)), ("de4", 64, 3, (128, 128))]
# (block, batch, c_in, (H, W)) where the JAX package's DenseBlock takes _run_cm
# (row tiles): final_dense at 480x640 and 512x768 images, dense1 at 512x768.
TILED_SHAPES = [(name, bsz, c, hw) for bsz in (2, 4) for name, c, hw in (
    ("final_dense", 3, (480, 640)), ("dense1", 64, (256, 384)), ("final_dense", 3, (512, 768)))]
# (block, batch, c_in, (H, W)) as the serving step gives them at the bench
# (B=128·256²) and eval (B=16·256×384) shapes.
DB_SHAPES = [
    ("dense1", BENCH_BATCH, 64, (128, 128)), ("dense2", BENCH_BATCH, 128, (64, 64)),
    ("dense3", BENCH_BATCH, 256, (32, 32)), ("final_dense", BENCH_BATCH, 3, (256, 256)),
    ("dense1", EVAL_BATCH, 64, (128, 192)), ("dense2", EVAL_BATCH, 128, (64, 96)),
    ("dense3", EVAL_BATCH, 256, (32, 48)), ("final_dense", EVAL_BATCH, 3, (256, 384)),
]


def read_config(task: str) -> dict:
    """A shipped config as a plain dict (the port's dialect: ``//`` comments)."""
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    return json.loads(json.dumps(load_config(str(CONFIG_DIR / f"{task}.json"))))


@contextlib.contextmanager
def tf32_defaults(torch):
    """PyTorch's TF32 defaults, as the CLI leaves them (cuDNN convs in TF32,
    matmuls in full f32), for the block; both off again after it."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} " \
              f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``reps`` calls
    (the port's benchmarks' timer)."""
    from multi_degradation_image_enhancement_tpu_torch.benchmarks import cuda_ms as timed

    return timed(fn, reps, warmup)


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


def _db_check(torch, label: str, got, ref) -> float:
    """The DenseBlock limits against plain: max <= 5e-2, mean <= 5e-3."""
    err = (got.float() - ref.float()).abs()
    say("dense_block", f"{label}: max {err.max().item():.3e} (limit 5e-2) mean "
        f"{err.mean().item():.3e} (limit 5e-3)")
    require(bool(torch.isfinite(got).all()), f"{label} finite")
    require(err.max().item() <= 5e-2 and err.mean().item() <= 5e-3, f"{label} kernel vs plain")
    return err.max().item()


def phase_dense_blocks(torch, model):
    """The DenseBlock kernels (bf16) vs their plain version (f32) at the
    eight block shapes of the serving forwards; then a ragged B=1 33x47
    image, growth 12, f32 I/O, and both NHWC entries (#3's, #10's) on f32
    and bf16 x, each a call of LAUNCHES_PER_BLOCK launches."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import DenseBlock
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK, dense_block, dense_block_plain, fold_dense_block, fused_dense_block,
        fused_dense_block_cm, pack_dense_block,
    )

    dev = torch.device("cuda")
    blocks = _cdan_blocks(model)
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
        err16 = (got.float() - ref_bf16.float()).abs().max().item()
        worst = max(worst, _db_check(torch, f"{name} B={bsz} c={c_in} {h}x{w} (vs plain-bf16 max "
                                     f"{err16:.3e})", got, ref))
    # growth 12 (slots padded to 16), with live statistics, at a ragged size
    torch.manual_seed(12)
    g12 = DenseBlock(64, growth_rate=12).eval()
    with torch.no_grad():
        for m in g12.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.05, 0.05)
                m.running_var.uniform_(0.1, 0.3)
    packs["growth12"] = pack_dense_block(g12.to(dev), dev)
    cases = [("final_dense", torch.bfloat16, (1, 3, 33, 47)), ("dense1", torch.bfloat16, (1, 64, 33, 47)),
             ("growth12", torch.bfloat16, (2, 64, 33, 47)), ("dense1", torch.float32, (2, 64, 32, 48)),
             ("final_dense", torch.float32, (1, 3, 33, 47))]
    for name, dt, shape in cases:
        x = torch.rand(shape, device=dev, generator=g).to(dt)
        n0 = dense_block.launches
        got = dense_block(x, packs[name])
        n = dense_block.launches - n0
        require(got.dtype == dt and got.shape == x.shape and n == LAUNCHES_PER_BLOCK,
                f"{name} {shape} {dt}: dtype, shape, {LAUNCHES_PER_BLOCK} launches")
        worst = max(worst, _db_check(torch, f"{name} {tuple(shape)} {dt}", got,
                                     dense_block_plain(x.float(), packs[name])))
    for entry in (fused_dense_block_cm, fused_dense_block):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.rand((2, 33, 47, 3), device=dev, generator=g).to(dt)
            got = entry(x, blocks["final_dense"])
            pack = (packs["final_dense"] if entry is fused_dense_block_cm
                    else fold_dense_block(blocks["final_dense"], dt, dev))
            ref = dense_block_plain(x.permute(0, 3, 1, 2).float(), pack).permute(0, 2, 3, 1)
            require(got.dtype == dt and got.shape == x.shape, f"{entry.__name__} dtype/shape")
            worst = max(worst, _db_check(torch, f"{entry.__name__} (NHWC) final_dense 2x33x47 {dt}",
                                         got, ref))
    return worst, packs


def live_cdan(torch, seed: int):
    """``init_cdan`` with BatchNorm statistics redrawn so the whole path
    answers: running means U(-0.05, 0.05), variances U(0.1, 0.3)."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan

    gen = torch.Generator().manual_seed(seed)
    model = init_cdan(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.05, 0.05, generator=gen)
                m.running_var.uniform_(0.1, 0.3, generator=gen)
    return model


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
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK, dense_block,
    )
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
        f"(expected noise {n_steps}, dense_block {4 * LAUNCHES_PER_BLOCK * n_steps})")
    require(launches["noise_degrade"] == n_steps, "one noise launch per step")
    require(launches["dense_block"] == 4 * LAUNCHES_PER_BLOCK * n_steps,
            "4 DenseBlocks x (entry + 4 growth + transition) launches per step")
    return launches, step, bench_clean, eval_clean


def _growth_inputs(torch, bsz, c, h, w, gen):
    """Seeded inputs of one growth layer: x, a, b, w (OIHW), bias, cotangent r."""
    dev = torch.device("cuda")

    def randn(*shape, s=1.0):
        return torch.randn(shape, device=dev, generator=gen) * s

    return (randn(bsz, c, h, w), torch.rand(c, device=dev, generator=gen) + 0.5,
            randn(c, s=0.1), randn(16, c, 3, 3, s=0.1), randn(16, s=0.1), randn(bsz, 16, h, w))


def _growth_run(torch, fn, x, a, b, w, bias, r):
    """(g, (dx, da, db, dw)) of ``fn`` with autograd on fresh leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, a, b, w, bias)]
    g = fn(*leaves)
    (g * r).sum().backward()
    return g.detach(), [leaves[i].grad for i in range(4)]


def phase_growth_train(torch):
    """Growth-train kernels vs the plain version at the 16 layer shapes of the
    train step (B=16) and the ragged ``GT_RAGGED`` shapes, f32 I/O, TF32 off:
    forward max <= 5e-2, mean <= 5e-3 (the DenseBlock contract); dx, da, db,
    dw each <= 2e-2 * max(scale, 1) (tests/test_growth_train.py:56); the
    backward is bit-for-bit repeatable."""
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer, growth_layer_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"fwd": 0.0, "bwd": 0.0}
    shapes = [(name, TRAIN_BATCH, c_in + 16 * i, hw, i == 3)
              for name, c_in, hw in GT_BLOCKS for i in range(4)]
    shapes += [("ragged", bsz, c, hw, True) for bsz, c, hw in GT_RAGGED]
    for name, bsz, c, (h, w), repeat in shapes:
        inp = _growth_inputs(torch, bsz, c, h, w, gen)
        g, grads = _growth_run(torch, growth_layer, *inp)
        g_ref, ref = _growth_run(torch, growth_layer_plain, *inp)
        torch.cuda.synchronize()
        err = (g - g_ref).abs()
        worst["fwd"] = max(worst["fwd"], err.max().item())
        rel = {}
        for gname, got, want in zip(("dx", "da", "db", "dw"), grads, ref):
            scale = want.abs().max().item()
            rel[gname] = (got - want).abs().max().item() / max(scale, 1.0)
            worst["bwd"] = max(worst["bwd"], (got - want).abs().max().item())
        say("growth_train", f"{name} c={c} B={bsz} {h}x{w}: fwd max "
            f"{err.max().item():.3e} mean {err.mean().item():.3e}; bwd err/max(scale,1) "
            + " ".join(f"{k} {v:.3e}" for k, v in rel.items()) + " (limit 2e-2)")
        require(err.max().item() <= 5e-2 and err.mean().item() <= 5e-3,
                f"growth forward {name} c={c}")
        require(all(v <= 2e-2 for v in rel.values()), f"growth backward {name} c={c}")
        if repeat:
            _, again = _growth_run(torch, growth_layer, *inp)
            require(all(torch.equal(p, q) for p, q in zip(grads, again)),
                    f"growth backward {name} c={c} is repeatable bit for bit")
    return worst


def growth_times(torch, smi):
    """Growth forward and backward per train step (the 16 layers at B=16),
    kernel vs plain (autograd over F.conv2d) and vs the module route (the
    unfused BN -> ReLU -> conv layer of ``models.cdan.DenseBlock`` in train
    mode under a bf16 autocast, forward and backward through cuDNN: the route
    ``fused_dense: false`` trains with; a yardstick the port never calls), by
    CUDA events."""
    from torch import nn

    from multi_degradation_image_enhancement_tpu_torch.models.norm import BatchNorm2d
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd, growth_layer_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(12)
    ms = {"fwd": 0.0, "bwd": 0.0, "plain_fwd": 0.0, "plain_bwd": 0.0, "module_fwd": 0.0,
          "module_bwd": 0.0}
    for name, c_in, (h, w) in GT_BLOCKS:
        block = dict.fromkeys(ms, 0.0)
        for i in range(4):
            c = c_in + 16 * i
            x, a, b, wt, bias, r = _growth_inputs(torch, TRAIN_BATCH, c, h, w, gen)
            w16 = wt.to(torch.bfloat16)
            block["fwd"] += cuda_ms(lambda: growth_layer_fwd(x, a, b, w16, bias), 5)
            block["bwd"] += cuda_ms(lambda: growth_layer_bwd(x, r, a, b, w16), 5)
            with torch.no_grad():
                block["plain_fwd"] += cuda_ms(lambda: growth_layer_plain(x, a, b, wt, bias), 3)
            leaves = [t.clone().requires_grad_(True) for t in (x, a, b, wt, bias)]
            g = growth_layer_plain(*leaves)
            block["plain_bwd"] += cuda_ms(
                lambda: torch.autograd.grad(g, leaves, r, retain_graph=True), 3)
            del g, leaves
            layer = nn.Sequential(BatchNorm2d(c), nn.ReLU(), nn.Conv2d(c, 16, 3, padding=1))
            layer = layer.to("cuda").train()
            xl = x.clone().requires_grad_(True)

            def module_fwd():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    return layer(xl)

            block["module_fwd"] += cuda_ms(module_fwd, 5)
            out = module_fwd()
            r16 = r.to(out.dtype)
            block["module_bwd"] += cuda_ms(lambda: torch.autograd.grad(
                out, [xl, *layer.parameters()], r16, retain_graph=True), 5)
            del out, layer, xl
        say("times", f"[{smi}] growth {name} (4 layers, B={TRAIN_BATCH} {h}x{w}): kernel fwd "
            f"{block['fwd']:.3f} bwd {block['bwd']:.3f} ms; plain fwd {block['plain_fwd']:.3f} "
            f"bwd {block['plain_bwd']:.3f} ms; module route fwd {block['module_fwd']:.3f} bwd "
            f"{block['module_bwd']:.3f} ms")
        for k in ms:
            ms[k] += block[k]
    fwd_bound, fwd_by = bound(*growth_train_work(False))
    bwd_bound, bwd_by = bound(*growth_train_work(True))
    say("times", f"[{smi}] growth layers per train step: kernel fwd {ms['fwd']:.3f} (bound "
        f"{fwd_bound:.3f} by {fwd_by}) + bwd {ms['bwd']:.3f} (bound {bwd_bound:.3f} by {bwd_by}) "
        f"= {ms['fwd'] + ms['bwd']:.3f} ms; plain fwd {ms['plain_fwd']:.3f} + bwd "
        f"{ms['plain_bwd']:.3f} = {ms['plain_fwd'] + ms['plain_bwd']:.3f} ms; module route fwd "
        f"{ms['module_fwd']:.3f} + bwd {ms['module_bwd']:.3f} = "
        f"{ms['module_fwd'] + ms['module_bwd']:.3f} ms")
    return ms


def _loss_config():
    return json.loads(CONFIG.read_text())["loss"]


def _train_once(torch, model, fused: bool, plain: bool, batch, masks):
    """One fp32 ``make_train_step`` on a copy of ``model``: (loss, grads, stats)."""
    import copy

    from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
    from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_plain,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline

    m = copy.deepcopy(model)
    m.fused_dense = fused
    if plain:
        for block in m.dense_blocks():
            block.growth_fn = growth_layer_plain
    state = TrainState.create(m, 1e-3)
    loss = make_train_step(build_loss_pipeline(_loss_config(), "cuda"), "fp32")(state, *batch, masks)
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    stats = {n: b.clone() for n, b in m.named_buffers() if n.endswith(("running_mean", "running_var"))}
    return float(loss["total"]), grads, stats


def _worst_rel(got, want):
    """Worst per-leaf max|got - want| / max|want| over the leaves whose scale
    is at least 1e-4 (conv biases feeding BatchNorm have zero gradient up to
    rounding dust; tests/test_growth_train.py skips them the same way)."""
    return max(((got[k] - want[k]).abs().max().item() / want[k].abs().max().item(), k)
               for k in want if want[k].abs().max().item() >= 1e-4)


def phase_train_step(torch):
    """A whole fp32 train step (2x256x384, the same weights, batch and dropout
    masks), growth kernels vs the plain growth layer: losses to 1e-3
    relative, running statistics to 1e-3, each gradient leaf within the class
    bound of test_fused_dense_block_gradient_class, max(2 * floor, 0.05), the
    floor being the plain fused step's own distance from the canonical (all
    f32) step."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan

    dev = torch.device("cuda")
    model = init_cdan(torch.Generator().manual_seed(21)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.rand((2, *EVAL_HW, 3), device=dev, generator=gen)
    t = torch.clamp(x + 0.1 * torch.randn(x.shape, device=dev, generator=gen), 0.0, 1.0)
    masks = [torch.rand((2, c, EVAL_HW[0] // p, EVAL_HW[1] // p), device=dev, generator=gen) < 0.8
             for c, p in ((64, 2), (128, 4), (256, 8), (512, 8))]
    k_loss, k_grads, k_stats = _train_once(torch, model, True, False, (x, t), masks)
    p_loss, p_grads, p_stats = _train_once(torch, model, True, True, (x, t), masks)
    _, c_grads, _ = _train_once(torch, model, False, False, (x, t), masks)
    torch.cuda.synchronize()
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    stats_err = max((k_stats[n] - p_stats[n]).abs().max().item() for n in p_stats)
    floor, floor_leaf = _worst_rel(p_grads, c_grads)
    err, leaf = _worst_rel(k_grads, p_grads)
    bound = max(2.0 * floor, 0.05)
    say("train_step", f"2x{EVAL_HW[0]}x{EVAL_HW[1]} fp32, kernels vs plain: loss {k_loss:.6f} vs "
        f"{p_loss:.6f} (rel {loss_rel:.3e}, limit 1e-3); running stats max {stats_err:.3e} "
        f"(limit 1e-3); worst gradient leaf {err:.3e} ({leaf}), limit {bound:.3e} = max(2 x "
        f"floor {floor:.3e} ({floor_leaf}), 0.05)")
    require(loss_rel <= 1e-3, "train-step loss, kernels vs plain")
    require(stats_err <= 1e-3, "train-step running statistics, kernels vs plain")
    require(err <= bound, "train-step gradients, kernels vs plain")


def phase_cli_train(torch, task: str = "noise_synthetic"):
    """``run.main`` on ``<task>.json`` cut to one epoch of 64 images (four
    steps at B=16·256x384, bf16, fused DenseBlocks, and the config's BN
    recalibration passes), on CUDA, with every growth launch counted."""
    import shutil

    from multi_degradation_image_enhancement_tpu_torch import run
    from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import dense_block
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd,
    )
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    work = Path("build") / "chip_smoke_train" / task
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = read_config(task)
    cfg["train"].update(n_epoch=1, model_path=str(work / "weights"))
    cfg["train"]["dataset"]["args"]["n_images"] = CLI_IMAGES
    cfg["logging"]["root_dir"] = str(work / "runs")
    (work / "config.json").write_text(json.dumps(cfg))
    config = load_config(str(work / "config.json"), phase="train")
    steps = CLI_IMAGES // cfg["train"]["dataloader"]["args"]["batch_size"]
    passes = (cfg["train"].get("bn_recalibration") or {}).get("passes", 0)

    growth_layer_fwd.launches = growth_layer_bwd.launches = dense_block.launches = 0
    t0 = time.perf_counter()
    engine = run.main(config)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"growth_train_fwd": growth_layer_fwd.launches,
                "growth_train_bwd": growth_layer_bwd.launches}

    (csv_path,) = (work / "runs").glob(f"{task}/*/train.csv")
    header, row = csv_path.read_text().splitlines()
    cols = dict(zip(header.split(","), row.split(",")))
    loss = float(cols["loss_total"])
    weights = work / "weights" / cfg["train"]["model_name"]
    load_weights(str(weights), CDAN())  # strict
    want_fwd, want_bwd = 16 * (steps + passes * steps), 16 * steps
    say("cli_train", f"{task}: {steps} steps B=16x256x384 {engine.precision}, fused_dense "
        f"{engine.network.fused_dense}, + {passes} recalibration passes in {seconds:.1f} s: "
        f"epoch loss {loss:.5f}; {weights} loads strictly; launches {launches} (expected fwd "
        f"{want_fwd} = 16 x ({steps} steps + {passes * steps} recalibration forwards), bwd "
        f"{want_bwd}); serving dense_block launches {dense_block.launches}")
    require(cols["type"] == "epoch" and cols["epoch"] == "1", "train.csv has its epoch row")
    require(math.isfinite(loss) and math.isfinite(engine.best_loss), "losses are finite")
    require(engine.precision == "bf16" and engine.network.fused_dense, "bf16 with fused DenseBlocks")
    require(launches["growth_train_fwd"] == want_fwd, "16 growth forwards per forward")
    require(launches["growth_train_bwd"] == want_bwd, "16 growth backwards per step")
    require(dense_block.launches == 0, "training runs no inference DenseBlock")
    return launches, engine


def train_times(torch, smi, engine):
    """Mean ms per bf16 train step at B=16·256x384 after warm-up (CUDA events
    around 10 steps of the CLI run's engine on one loader batch), and img/s."""
    inputs, targets, mask = next(iter(engine.dataloader))
    gen = torch.Generator(device="cuda").manual_seed(5)
    step_ms = cuda_ms(lambda: engine._train_step(engine.state, inputs, targets, gen, mask), 10, 3)
    say("times", f"[{smi}] train step B={TRAIN_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} bf16, fused "
        f"DenseBlocks: {step_ms:.3f} ms/step, {TRAIN_BATCH / step_ms * 1e3:.1f} img/s")
    return step_ms


def phase_times(torch, smi, step, bench_clean, eval_clean, packs, model):
    """Serving step ms and img/s; the noise kernel vs plain; each of the four
    DenseBlocks at B=128·256²: kernels, plain, the module route (the unfused
    ``models.cdan.DenseBlock`` under a bf16 autocast, cuDNN convs: what the
    pipeline's experts run) and this design's traffic floor."""
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
        ),
        "serving_step_ms": step_ms,
    }
    g = torch.Generator(device="cuda").manual_seed(4)
    blocks = _cdan_blocks(model)
    sums = {"kernel": 0.0, "plain": 0.0, "module": 0.0, "floor": 0.0}
    for name, bsz, c_in, (h, w) in DB_SHAPES[:4]:
        x = torch.rand((bsz, c_in, h, w), device="cuda", generator=g).to(torch.bfloat16)
        module = blocks[name].to("cuda").eval()

        def module_route():
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                return module(x)

        t = {"kernel": cuda_ms(lambda: dense_block(x, packs[name]), 10),
             "plain": cuda_ms(lambda: dense_block_plain(x, packs[name]), 5),
             "module": cuda_ms(module_route, 10),
             "floor": dense_block_traffic([(bsz, c_in, h, w)]) / HBM_BYTES_PER_S * 1e3}
        for k in sums:
            sums[k] += t[k]
        say("times", f"[{smi}] dense_block {name} B={bsz} c={c_in} {h}x{w} bf16: kernel "
            f"{t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, module route {t['module']:.3f} ms, "
            f"traffic floor {t['floor']:.3f} ms")
    times["dense_block"] = (sums["kernel"], sums["plain"])
    times["dense_block_module_ms"] = sums["module"]
    say("times", f"[{smi}] noise_degrade B={BENCH_BATCH}x{BENCH_SIZE}^2 bf16 out: kernel "
        f"{times['noise_degrade'][0]:.3f} ms, plain {times['noise_degrade'][1]:.3f} ms; "
        f"dense_block x4 per step: kernel {sums['kernel']:.3f} ms, plain {sums['plain']:.3f} ms, "
        f"module route {sums['module']:.3f} ms, traffic floor {sums['floor']:.3f} ms")
    return times


def _conv_pairs(torch, model, bsz=BENCH_BATCH, hw=(BENCH_SIZE, BENCH_SIZE)):
    """(name, pack, x) of conv1's #9 call at both serving shapes and the
    seven #8 calls of a B=``bsz``·``hw`` CM forward, with the model's folded
    weights and bf16 inputs drawn U(0, 1)."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import _fold_all
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import pack_conv

    dev = torch.device("cuda")
    folded = _fold_all(model)
    g = torch.Generator(device=dev).manual_seed(13)

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=g).to(torch.bfloat16)

    pool = [(f"conv1 B={b} {h}x{w}", pack_conv(*folded["conv1"], device=dev), rand(b, 3, h, w))
            for b, (h, w) in ((BENCH_BATCH, (BENCH_SIZE, BENCH_SIZE)), (EVAL_BATCH, EVAL_HW))]
    convs = []
    for name, c_in, c_out, (h256, _) in CM_CONVS:  # at 1/2, 1/4 or 1/8 of the image
        h, w = (v // (BENCH_SIZE // h256) for v in hw)
        convs.append((f"{name} {c_in}->{c_out} B={bsz} {h}x{w}", pack_conv(*folded[name], device=dev),
                      rand(bsz, c_in, h, w)))
    return pool, convs


def phase_conv_kernels(torch, model):
    """#9 and #8 (bf16 in and out) vs their plain versions on the same bf16
    inputs in f32, TF32 off: max <= 5e-2, mean <= 5e-3
    (tests/test_pallas_kernels.py:259-260,299-300).  #9 at conv1 of both
    serving shapes, at c_in 8 -> c_out 16 and 64 -> 128 (B=3, 16×32: K
    chunks, several M tiles), at a ragged 10×18 (pooled 5×9: clipped tiles)
    and with an f32 x (f32 out).  #8 at the seven CM conv shapes of
    B=128·256² and of B=16·256×384, at c_in = 72 (a ragged 64-channel K
    step) with c_out = 3, at 32×34 (rows of 34 pixels: the 8-pixel tiles and
    the edge) and with an f32 x (rounded to bf16 by the NHWC pass, f32 out)."""
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import (
        conv3x3, conv3x3_plain, conv3x3_pool, conv3x3_pool_plain, pack_conv,
    )

    dev = torch.device("cuda")
    pool, convs = _conv_pairs(torch, model)
    convs += _conv_pairs(torch, model, EVAL_BATCH, EVAL_HW)[1]
    g = torch.Generator(device=dev).manual_seed(17)
    w72 = torch.randn((3, 72, 3, 3), device=dev, generator=g) * (2.0 / (9 * 72)) ** 0.5
    pack72 = pack_conv(w72, torch.randn((3,), device=dev, generator=g) * 0.1, device=dev)
    convs.append(("72->3 B=4 96x136", pack72,
                  torch.rand((4, 72, 96, 136), device=dev, generator=g).to(torch.bfloat16)))
    convs.append(("conv2 64->128 B=2 32x34", convs[0][1],
                  torch.rand((2, 64, 32, 34), device=dev, generator=g).to(torch.bfloat16)))
    _, f32_pack, f32_x = convs[len(CM_CONVS)]  # conv2 at the eval shape, f32 in and out
    convs.append(("conv2 B=16 128x192 f32", f32_pack, f32_x.float()))
    for c_in, c_out in ((8, 16), (64, 128)):
        w = torch.randn((c_out, c_in, 3, 3), device=dev, generator=g) * (2.0 / (9 * c_in)) ** 0.5
        pool.append((f"{c_in}->{c_out} B=3 16x32", pack_conv(
            w, torch.randn((c_out,), device=dev, generator=g) * 0.1, device=dev),
            torch.rand((3, c_in, 16, 32), device=dev, generator=g).to(torch.bfloat16)))
    conv1 = pool[0][1]
    pool.append(("conv1 B=2 10x18", conv1,
                 torch.rand((2, 3, 10, 18), device=dev, generator=g).to(torch.bfloat16)))
    pool.append(("conv1 B=16 256x384 f32", conv1, pool[1][2].float()))
    worst = {"conv3x3_pool": 0.0, "conv3x3": 0.0}
    for kname, kern, plain, pairs in (("conv3x3_pool", conv3x3_pool, conv3x3_pool_plain, pool),
                                      ("conv3x3", conv3x3, conv3x3_plain, convs)):
        for label, pack, x in pairs:
            got = kern(x, pack)
            ref = plain(x.float(), pack)
            torch.cuda.synchronize()
            require(got.dtype == x.dtype and got.shape == ref.shape, f"{kname} {label} shape")
            err = (got.float() - ref).abs()
            worst[kname] = max(worst[kname], err.max().item())
            say("conv_kernels", f"{kname} {label}: max {err.max().item():.3e} (limit 5e-2) mean "
                f"{err.mean().item():.3e} (limit 5e-3)")
            require(err.max().item() <= 5e-2 and err.mean().item() <= 5e-3, f"{kname} {label}")
    return worst


def phase_cm_forward(torch, model):
    """The bf16 CM forward vs the f32 ``CDAN`` at 2x256² and 2x256x384, with
    the default conv table and with every conv on #8 (7 launches a forward):
    max <= 2e-2, mean <= 2e-3 (tests/test_cdan_fast.py:108-109)."""
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import conv3x3, conv3x3_pool

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    model = model.to(dev)
    default = dict(cdan_fast._CM_CONV_IMPL)
    for hw in ((BENCH_SIZE, BENCH_SIZE), EVAL_HW):
        x = torch.rand((2, *hw, 3), device=dev, generator=g)
        with torch.inference_mode():
            ref = model(x)
        for table in ("default", "kernel"):
            if table == "kernel":
                cdan_fast._CM_CONV_IMPL.update(dict.fromkeys(default, "kernel"))
            try:
                n0 = (conv3x3.launches, conv3x3_pool.launches)
                got = cdan_fast.build_fast_apply_cm(model, torch.bfloat16, dev)(x)
                torch.cuda.synchronize()
                n = (conv3x3.launches - n0[0], conv3x3_pool.launches - n0[1])
            finally:
                cdan_fast._CM_CONV_IMPL.update(default)
            err = (got - ref).abs()
            say("cm_forward", f"2x{hw[0]}x{hw[1]} conv table {table}: max {err.max().item():.3e} "
                f"(limit 2e-2) mean {err.mean().item():.3e} (limit 2e-3); launches conv3x3 {n[0]} "
                f"conv3x3_pool {n[1]}")
            require(got.shape == ref.shape and bool(torch.isfinite(got).all()), "CM forward shape")
            require(err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, f"CM forward {table}")
            require(n == ((7 if table == "kernel" else 0), 1), "conv launches of one CM forward")


def phase_tiled_shapes(torch, model):
    """The DenseBlock kernel at the shapes where the JAX package takes the
    row-tiled ``_run_cm`` (#3), vs its plain version in f32 (the DenseBlock
    limits: max <= 5e-2, mean <= 5e-3); ``fused_dense_block_cm`` once; the
    whole per-block forward at 2x480x640 vs the f32 ``CDAN`` (2e-2, 2e-3)."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        dense_block, dense_block_plain, fused_dense_block_cm, pack_dense_block,
    )

    dev = torch.device("cuda")
    model = model.to(dev)
    blocks = {"dense1": model.encoder.dense1, "final_dense": model.decoder.final_dense}
    packs = {name: pack_dense_block(block, dev) for name, block in blocks.items()}
    g = torch.Generator(device=dev).manual_seed(15)
    worst = 0.0
    for name, bsz, c_in, (h, w) in TILED_SHAPES:
        x = torch.rand((bsz, c_in, h, w), device=dev, generator=g).to(torch.bfloat16)
        got = dense_block(x, packs[name])
        ref = dense_block_plain(x.float(), packs[name])
        torch.cuda.synchronize()
        err = (got.float() - ref).abs()
        worst = max(worst, err.max().item())
        say("tiled_shapes", f"{name} B={bsz} c={c_in} {h}x{w}: max {err.max().item():.3e} "
            f"(limit 5e-2) mean {err.mean().item():.3e} (limit 5e-3)")
        require(err.max().item() <= 5e-2 and err.mean().item() <= 5e-3, f"{name} {h}x{w}")
    x = torch.rand((2, *PHOTO_HW, 3), device=dev, generator=g)
    got = fused_dense_block_cm(x, blocks["final_dense"])
    ref = dense_block_plain(x.permute(0, 3, 1, 2).contiguous(), packs["final_dense"])
    err = (got - ref.permute(0, 2, 3, 1)).abs()
    say("tiled_shapes", f"fused_dense_block_cm (NHWC) final_dense 2x{PHOTO_HW[0]}x{PHOTO_HW[1]}: "
        f"max {err.max().item():.3e} mean {err.mean().item():.3e}")
    require(got.shape == x.shape and err.max().item() <= 5e-2 and err.mean().item() <= 5e-3,
            "fused_dense_block_cm vs plain")
    with torch.inference_mode():
        ref = model(x)
        got = build_serving_apply(model, torch.bfloat16, dev, prefer_cm=False)(x)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    say("tiled_shapes", f"per-block forward bf16 vs f32 CDAN at 2x{PHOTO_HW[0]}x{PHOTO_HW[1]}: "
        f"max {err.max().item():.3e} (limit 2e-2) mean {err.mean().item():.3e} (limit 2e-3)")
    require(err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, "per-block forward 480x640")
    return worst


def phase_requests_cm(torch):
    """Serving steps with ``prefer_cm`` at B=128·256²: with the default conv
    table, one conv+pool and 20 DenseBlock launches a step and no #8 launch;
    with every conv on #8 (the A/B setting of ``benchmarks/ablate_cm.py``), 7
    #8 launches a step more.  Returns the launches and both steps."""
    from multi_degradation_image_enhancement_tpu_torch import serving
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import conv3x3, conv3x3_pool
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK, dense_block,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import noise_degrade_01

    default = dict(cdan_fast._CM_CONV_IMPL)
    step, clean = serving.build_pipeline(BENCH_BATCH, BENCH_SIZE, torch.bfloat16, "cuda",
                                         prefer_cm=True)
    cdan_fast._CM_CONV_IMPL.update(dict.fromkeys(default, "kernel"))
    try:
        step_k, _ = serving.build_pipeline(BENCH_BATCH, BENCH_SIZE, torch.bfloat16, "cuda",
                                           prefer_cm=True)
    finally:
        cdan_fast._CM_CONV_IMPL.update(default)
    gen = torch.Generator().manual_seed(3)
    launches = {}
    for table, fn in (("default", step), ("kernel", step_k)):
        fn(clean, gen)  # warm-up
        torch.cuda.synchronize()
        noise_degrade_01.launches = dense_block.launches = 0
        conv3x3.launches = conv3x3_pool.launches = 0
        outs = [fn(clean, gen) for _ in range(BENCH_STEPS)]
        torch.cuda.synchronize()
        n = {"noise_degrade": noise_degrade_01.launches, "dense_block": dense_block.launches,
             "conv3x3_pool": conv3x3_pool.launches, "conv3x3": conv3x3.launches}
        for out in outs:
            require(tuple(out.shape) == (BENCH_BATCH, BENCH_SIZE, BENCH_SIZE, 3), "output shape")
            require(bool(torch.isfinite(out).all()) and out.min().item() >= 0.0
                    and out.max().item() <= 1.0, "outputs finite, in [0, 1]")
        want = {"noise_degrade": BENCH_STEPS, "dense_block": 4 * LAUNCHES_PER_BLOCK * BENCH_STEPS,
                "conv3x3_pool": BENCH_STEPS, "conv3x3": (7 if table == "kernel" else 0) * BENCH_STEPS}
        say("requests_cm", f"{BENCH_STEPS} steps B={BENCH_BATCH}x{BENCH_SIZE}^2 prefer_cm, conv "
            f"table {table}: finite, in [0,1]; launches {n} (expected {want})")
        require(n == want, f"prefer_cm launches, conv table {table}")
        launches[table] = n
    return launches, step, step_k, clean


def _cli_test(torch, name: str, ckpt_dir: Path, env=None, hw=None, images=TEST_IMAGES,
              task: str = "noise_synthetic"):
    """One ``run.main`` ``-p test`` on ``<task>.json``'s test block cut to
    ``images`` images (optionally resized to ``hw``), scoring the checkpoint
    in ``ckpt_dir``, every launch counted; with post-processing on, the
    ``post`` row and the post-processed PNGs too.  Returns its record."""
    import os
    import shutil

    from multi_degradation_image_enhancement_tpu_torch import run
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import conv3x3, conv3x3_pool
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK, dense_block,
    )
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    work = Path("build") / "chip_smoke_test" / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = read_config(task)
    cfg["test"].update(model_path=str(ckpt_dir))
    cfg["test"]["dataset"]["args"]["n_images"] = images
    if hw is not None:
        for op in cfg["test"]["dataset"]["args"]["transform"]["ops"]:
            if op["name"] == "Resize":
                op["args"] = {"height": hw[0], "width": hw[1]}
    cfg["save_outputs"]["output_dir"] = str(work / "outputs")
    cfg["logging"]["root_dir"] = str(work / "runs")
    (work / "config.json").write_text(json.dumps(cfg))
    config = load_config(str(work / "config.json"), phase="test")
    bsz = cfg["test"]["dataloader"]["args"]["batch_size"]
    batches = -(-images // bsz)

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        dense_block.launches = conv3x3.launches = conv3x3_pool.launches = 0
        t0 = time.perf_counter()
        engine = run.main(config)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"dense_block": dense_block.launches, "conv3x3_pool": conv3x3_pool.launches,
                    "conv3x3": conv3x3.launches}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    (csv_path,) = (work / "runs").glob(f"{task}/*/test.csv")
    header, *lines = csv_path.read_text().splitlines()
    rows = {r["stage"]: r for r in (dict(zip(header.split(","), ln.split(","))) for ln in lines)}
    summary = json.loads((csv_path.parent / "summary.json").read_text())
    post_on = bool(cfg["post_processing"]["enabled"])
    pngs = sorted((work / "outputs").glob(f"{cfg['save_outputs']['raw_prefix']}*.png"))
    pp_pngs = sorted((work / "outputs").glob(f"{cfg['save_outputs']['post_prefix']}*.png"))
    keys = ("loss_total", "metric_psnr", "metric_ssim", "metric_lpips")
    scores = {k: float(rows["pre"][k]) for k in keys}
    post = {k: float(rows["post"][k]) for k in keys} if "post" in rows else None
    hw_s = f"{hw[0]}x{hw[1]}" if hw else f"{EVAL_HW[0]}x{EVAL_HW[1]}"
    say("cli_test", f"{name}: {images} images B={bsz} {hw_s} {engine.precision} in {seconds:.2f} s "
        f"({images / seconds:.1f} img/s with PNG writes): pre {scores}" + (f", post {post}" if post
        else "") + f"; {len(pngs)} raw + {len(pp_pngs)} post-processed PNGs; summary "
        f"test_batches {summary.get('test_batches')}, pretrained_weights "
        f"{summary.get('pretrained_weights')}; launches {launches}")
    require(sorted(rows) == (["post", "pre"] if post_on else ["pre"]), "test.csv has its stage rows")
    for cols in rows.values():
        require(cols["type"] == "test" and int(cols["batches"]) == batches, "test.csv rows")
    require(all(math.isfinite(v) for v in scores.values()), "PRE loss, PSNR, SSIM, LPIPS finite")
    require(post is None or all(math.isfinite(v) for v in post.values()), "POST scores finite")
    require(summary.get("test_batches") == batches
            and summary.get("post_processing_enabled") == post_on, "summary.json has its test entries")
    require(len(pngs) == images, "one raw PNG per scored image")
    want_pp = images if post_on and cfg["save_outputs"].get("save_postprocessed") else 0
    require(len(pp_pngs) == want_pp, "one post-processed PNG per scored image where configured")
    require(launches["dense_block"] == 4 * LAUNCHES_PER_BLOCK * batches,
            f"{4 * LAUNCHES_PER_BLOCK} DenseBlock launches per batch")
    return {"seconds": seconds, "launches": launches, "engine": engine, "scores": scores,
            "batches": batches}


def phase_cli_test(torch, train_engine):
    """``-p test`` through ``run.main``: as shipped (per-block forward),
    with ``prefer_cm`` from a tuning copy (one #9 launch per batch), and at
    480x640 (the JAX package's #3 route)."""
    ckpt_dir = Path(train_engine.model_path)
    shipped = _cli_test(torch, "shipped", ckpt_dir)
    require(shipped["launches"]["conv3x3_pool"] == 0, "the shipped tuning runs no conv+pool")
    tuning = json.loads((CONFIG.parent / "serving_tuning.json").read_text())
    tuning["prefer_cm"] = True
    tuning_path = Path("build") / "chip_smoke_test" / "serving_tuning_prefer_cm.json"
    tuning_path.write_text(json.dumps(tuning))
    cm = _cli_test(torch, "prefer_cm", ckpt_dir, env={"MDIE_SERVING_TUNING": str(tuning_path)})
    require(cm["launches"]["conv3x3_pool"] == cm["batches"], "one conv+pool launch per batch")
    photo = _cli_test(torch, "photo_480x640", ckpt_dir, hw=PHOTO_HW, images=PHOTO_IMAGES)
    for a, b in (("metric_psnr", 0.5), ("metric_ssim", 0.02)):
        require(abs(shipped["scores"][a] - cm["scores"][a]) <= b, f"{a}: CM and per-block agree")
    return shipped, cm, photo


def eval_times(torch, smi, model, shipped, step, step_k, clean):
    """CUDA-event times: #8 and #9 vs plain, #9 vs its cuDNN module route,
    the CM vs the per-block forward, the eval step per B=16 batch, the
    DenseBlock at the photo shape; with the wall time of each ``-p test``."""
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import (
        conv3x3, conv3x3_plain, conv3x3_pool, conv3x3_pool_plain,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        dense_block, dense_block_plain, pack_dense_block,
    )

    dev = torch.device("cuda")
    pool, convs = _conv_pairs(torch, model)
    times = {}
    for kname, kern, plain, pairs in (("conv3x3_pool", conv3x3_pool, conv3x3_pool_plain, pool[:1]),
                                      ("conv3x3", conv3x3, conv3x3_plain, convs)):
        k_ms = p_ms = 0.0
        for label, pack, x in pairs:
            a, b = cuda_ms(lambda: kern(x, pack), 10), cuda_ms(lambda: plain(x, pack), 5)
            k_ms, p_ms = k_ms + a, p_ms + b
            say("times", f"[{smi}] {kname} {label} bf16: kernel {a:.3f} ms, plain {b:.3f} ms")
        times[kname] = (k_ms, p_ms)
    say("times", f"[{smi}] conv3x3 x7 per B={BENCH_BATCH}x{BENCH_SIZE}^2 CM forward: kernel "
        f"{times['conv3x3'][0]:.3f} ms, plain {times['conv3x3'][1]:.3f} ms")
    import torch.nn.functional as F

    label, pack, x = pool[0]
    b16 = pack.bias.to(torch.bfloat16)
    times["conv3x3_pool_module_ms"] = cuda_ms(
        lambda: F.max_pool2d(torch.relu(F.conv2d(x, pack.w_bf16, b16, padding=1)), 2), 10)
    say("times", f"[{smi}] conv3x3_pool {label} bf16: module route (cuDNN conv + bias, ReLU, "
        f"max_pool2d) {times['conv3x3_pool_module_ms']:.3f} ms, kernel "
        f"{times['conv3x3_pool'][0]:.3f} ms")

    model = model.to(dev)
    g = torch.Generator(device=dev).manual_seed(16)
    for bsz, hw in ((BENCH_BATCH, (BENCH_SIZE, BENCH_SIZE)), (EVAL_BATCH, EVAL_HW)):
        x = torch.rand((bsz, *hw, 3), device=dev, generator=g)
        cm = cdan_fast.build_fast_apply_cm(model, torch.bfloat16, dev)
        pb = cdan_fast.build_fast_apply(model, torch.bfloat16, dev)
        a, b = cuda_ms(lambda: cm(x), 10), cuda_ms(lambda: pb(x), 10)
        say("times", f"[{smi}] forward B={bsz}x{hw[0]}x{hw[1]} bf16: CM {a:.3f} ms/step, "
            f"per-block {b:.3f} ms/step")
    gen = torch.Generator().manual_seed(4)
    a, b = cuda_ms(lambda: step(clean, gen), 10), cuda_ms(lambda: step_k(clean, gen), 5)
    say("times", f"[{smi}] degrade->restore prefer_cm B={BENCH_BATCH}x{BENCH_SIZE}^2: default conv "
        f"table {a:.3f} ms/step ({BENCH_BATCH / a * 1e3:.1f} img/s); every conv on #8 {b:.3f} ms/step")

    engine = shipped["engine"]
    eval_step = engine._build_eval_step(engine._load_for_eval())
    inputs, targets, mask = next(iter(engine.dataloader))
    fwd_ms = cuda_ms(lambda: eval_step(inputs), 10)
    full_ms = cuda_ms(lambda: eval_step(inputs, targets, mask), 10)
    say("times", f"[{smi}] eval step B={EVAL_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]}: forward {fwd_ms:.3f} ms"
        f" + loss and metrics {full_ms - fwd_ms:.3f} ms = {full_ms:.3f} ms per batch")
    # host wall of one batch's PNGs (copy to the host, 4 writer threads), and
    # of synthesising the 64-image test set (set-up of every -p test run)
    out = eval_step(inputs)["raw"]
    engine.save_cfg["output_dir"] = str(Path("build") / "chip_smoke_test" / "png_timing")
    t0 = time.perf_counter()
    engine._save_batch_outputs(out, 0, "t_")
    engine._drain_writers()
    png_s = time.perf_counter() - t0
    engine._writer_pool.shutdown(wait=True)
    from multi_degradation_image_enhancement_tpu_torch.utils.registry import define_dataset

    t0 = time.perf_counter()
    define_dataset(engine.config["test"]["dataset"])
    synth_s = time.perf_counter() - t0
    say("times", f"[{smi}] -p test host work: PNG writes {png_s * 1e3:.1f} ms per batch of "
        f"{EVAL_BATCH}; test-set synthesis {synth_s:.2f} s for {TEST_IMAGES} images")

    pack = pack_dense_block(model.decoder.final_dense, dev)
    x = torch.rand((EVAL_BATCH, 3, *PHOTO_HW), device=dev, generator=g).to(torch.bfloat16)
    times["dense_block_tiled"] = (cuda_ms(lambda: dense_block(x, pack), 10),
                                  cuda_ms(lambda: dense_block_plain(x, pack), 5))
    say("times", f"[{smi}] dense_block final_dense B={EVAL_BATCH} c=3 {PHOTO_HW[0]}x{PHOTO_HW[1]}: "
        f"kernel {times['dense_block_tiled'][0]:.3f} ms, plain {times['dense_block_tiled'][1]:.3f} ms")
    return times



def _cdan_blocks(model) -> dict:
    return {"dense1": model.encoder.dense1, "dense2": model.encoder.dense2,
            "dense3": model.encoder.dense3, "final_dense": model.decoder.final_dense}


def phase_fused_dense_block(torch, smi, model):
    """#10's entry ``fused_dense_block`` (NHWC, the affine folded in x's
    dtype) vs its plain version (``dense_block_plain`` on the same fold) at
    the four block shapes of the B=16·256x384 forward, f32 and bf16 x: max
    <= 5e-2, mean <= 5e-3, LAUNCHES_PER_BLOCK launches a call.  Then the public entry on those
    four blocks (bf16) with the counter reset: 4 x LAUNCHES_PER_BLOCK.  Times (bf16,
    the four blocks): the entry, ``fused_dense_block_cm``, plain."""
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK, dense_block, dense_block_plain, fold_dense_block, fused_dense_block,
        fused_dense_block_cm,
    )

    dev = torch.device("cuda")
    blocks = _cdan_blocks(model.to(dev))
    g = torch.Generator(device=dev).manual_seed(17)
    shapes = DB_SHAPES[4:]
    worst = 0.0
    for name, bsz, c_in, (h, w) in shapes:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.rand((bsz, h, w, c_in), device=dev, generator=g).to(dt)
            n0 = dense_block.launches
            got = fused_dense_block(x, blocks[name])
            n = dense_block.launches - n0
            pack = fold_dense_block(blocks[name], dt, dev)
            ref = dense_block_plain(x.permute(0, 3, 1, 2).contiguous(), pack).permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            require(got.dtype == dt and got.shape == x.shape, f"#10 {name} {dt} output dtype/shape")
            err = (got.float() - ref.float()).abs()
            worst = max(worst, err.max().item())
            say("fused_dense_block", f"{name} B={bsz} c={c_in} {h}x{w} {dt}: max "
                f"{err.max().item():.3e} (limit 5e-2) mean {err.mean().item():.3e} (limit 5e-3); "
                f"launches {n} (expected {LAUNCHES_PER_BLOCK})")
            require(err.max().item() <= 5e-2 and err.mean().item() <= 5e-3, f"#10 {name} {dt}")
            require(n == LAUNCHES_PER_BLOCK, "#10: entry + 4 growth + transition launches a call")
    xs = {name: torch.rand((bsz, h, w, c), device=dev, generator=g).to(torch.bfloat16)
          for name, bsz, c, (h, w) in shapes}
    torch.cuda.synchronize()
    dense_block.launches = 0
    outs = [fused_dense_block(xs[name], blocks[name]) for name in xs]
    torch.cuda.synchronize()
    launches = dense_block.launches
    require(all(bool(torch.isfinite(o).all()) for o in outs), "#10 outputs finite")
    say("fused_dense_block", f"public entry on the four blocks of B={EVAL_BATCH}x{EVAL_HW[0]}x"
        f"{EVAL_HW[1]} bf16: launches {launches} (expected {4 * LAUNCHES_PER_BLOCK})")
    require(launches == 4 * LAUNCHES_PER_BLOCK, "#10 public entry: four blocks' launches")
    ms = {"kernel": 0.0, "cm_entry": 0.0, "plain": 0.0}
    for name, x in xs.items():
        pack = fold_dense_block(blocks[name], torch.bfloat16, dev)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        t = {"kernel": cuda_ms(lambda: fused_dense_block(x, blocks[name]), 10),
             "cm_entry": cuda_ms(lambda: fused_dense_block_cm(x, blocks[name]), 10),
             "plain": cuda_ms(lambda: dense_block_plain(x_nchw, pack), 5)}
        say("times", f"[{smi}] {name} {tuple(x.shape)} bf16: fused_dense_block {t['kernel']:.3f} ms, "
            f"fused_dense_block_cm {t['cm_entry']:.3f} ms, plain {t['plain']:.3f} ms")
        for k in ms:
            ms[k] += t[k]
    say("times", f"[{smi}] four blocks B={EVAL_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} bf16: "
        f"fused_dense_block {ms['kernel']:.3f} ms, fused_dense_block_cm {ms['cm_entry']:.3f} ms, "
        f"plain {ms['plain']:.3f} ms")
    return worst, launches, ms


def phase_degradations(torch, smi):
    """The nine degradations at B=16·256x384 (procedural clean images on the
    uint8 lattice) on the card vs the same function on the CPU with the same
    explicit parameters, TF32 at PyTorch's defaults.  Pass: |d| <= 1 LSB and
    >= 99.9% of values identical; jpeg: >= 99.5% identical and PSNR(card,
    CPU) >= 50 dB.  Each one's ms per batch on the card."""
    from multi_degradation_image_enhancement_tpu_torch.data.synthetic import _procedural_clean
    from multi_degradation_image_enhancement_tpu_torch.ops import degradations as deg

    with tf32_defaults(torch) as flags:
        say("degradations", f"{flags} (PyTorch's defaults)")
        clean = torch.from_numpy(_procedural_clean(EVAL_BATCH, *EVAL_HW, seed=7)).float()
        card = clean.cuda()
        times = {}
        for i, name in enumerate(deg.DEGRADATIONS):
            gen = torch.Generator().manual_seed(100 + i)
            params = deg.sample_params(name, gen, EVAL_BATCH)
            if name == "noise":
                params["normal"] = torch.randn(clean.shape, generator=gen)
            want = deg.apply_with_params(name, clean, params)
            on_card = {k: v.cuda() for k, v in params.items()}
            got = deg.apply_with_params(name, card, on_card).cpu()
            diff = (got - want).abs()
            same = (diff == 0).float().mean().item()
            mse = diff.square().mean().item()
            psnr = math.inf if mse == 0 else 10.0 * math.log10(255.0 ** 2 / mse)
            times[name] = cuda_ms(lambda: deg.apply_with_params(name, card, on_card), 10)
            say("degradations", f"{name} B={EVAL_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]}: card vs CPU max "
                f"|d| {diff.max().item():.1f}, identical {same:.6f}, PSNR {psnr:.2f} dB; "
                f"[{smi}] {times[name]:.3f} ms per batch")
            if name == "jpeg":
                require(same >= 0.995 and psnr >= 50.0, "jpeg card vs CPU")
            else:
                require(diff.max().item() <= 1.0 and same >= 0.999, f"{name} card vs CPU")
    return times


def phase_cli_configs(torch):
    """Phase 20: train one epoch of 64 images and score 64 test images for
    each of ``CLI_TASKS`` through ``run.main``; growth-train and DenseBlock
    launches counted in each."""
    records = {}
    for task in CLI_TASKS:
        launches, engine = phase_cli_train(torch, task)
        test = _cli_test(torch, task, Path(engine.model_path), task=task)
        require(launches["growth_train_fwd"] > 0 and launches["growth_train_bwd"] > 0
                and test["launches"]["dense_block"] > 0, f"{task}: kernels launched")
        records[task] = {"launches": launches, "engine": engine, "test": test}
    return records


def perceptual_times(torch, smi, engine, noise_ms):
    """jpeg_synthetic's bf16 train step (CUDA events, 10 steps after 3 warm-up
    on one loader batch) with its loss as configured and with the VGG19 and
    LPIPS terms taken out; noise's step beside it."""
    from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline

    loss_cfg = json.loads(json.dumps(engine.config["loss"]))
    loss_cfg["terms"] = [t for t in loss_cfg["terms"] if t["name"] not in ("vgg_perceptual", "lpips")]
    inputs, targets, mask = next(iter(engine.dataloader))
    gen = torch.Generator(device="cuda").manual_seed(6)
    full = cuda_ms(lambda: engine._train_step(engine.state, inputs, targets, gen, mask), 10, 3)
    step = make_train_step(build_loss_pipeline(loss_cfg, "cuda"), engine.precision)
    bare = cuda_ms(lambda: step(engine.state, inputs, targets, gen, mask), 10, 3)
    say("times", f"[{smi}] jpeg_synthetic train step B={TRAIN_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} "
        f"bf16: {full:.3f} ms/step ({TRAIN_BATCH / full * 1e3:.1f} img/s); without VGG19 + LPIPS "
        f"{bare:.3f} ms ({TRAIN_BATCH / bare * 1e3:.1f} img/s): perceptual share "
        f"{1.0 - bare / full:.3f}; noise_synthetic {noise_ms:.3f} ms/step "
        f"({TRAIN_BATCH / noise_ms * 1e3:.1f} img/s)")
    return full, bare


GROWTH_KERNELS = ("growth_fwd_kernel", "growth_bwd_kernel", "growth_bwd_sum_kernel")


def profile_step(torch, smi, engine, steps: int = 3):
    """``torch.profiler`` over ``steps`` train steps of ``engine`` after two
    warm-up steps: the device time a step (the sum over CUDA kernel rows),
    its share of the profiled wall time, the growth-train kernels' time and
    share of it, and the ten kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    inputs, targets, mask = next(iter(engine.dataloader))
    gen = torch.Generator(device="cuda").manual_seed(7)
    for _ in range(2):
        engine._train_step(engine.state, inputs, targets, gen, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._train_step(engine.state, inputs, targets, gen, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total_ms = sum(device_us(e) for e in kernels) / 1e3 / steps
    require(total_ms > 0, "the profiler saw device time")
    say("profile", f"[{smi}] {engine.config['name']} train step under torch.profiler: "
        f"{total_ms:.3f} ms of kernels a step, {wall_ms:.3f} ms wall, busy share "
        f"{total_ms / wall_ms:.3f}")
    growth = {name: sum(device_us(e) for e in kernels if name in e.key) / 1e3 / steps
              for name in GROWTH_KERNELS}
    growth_ms = sum(growth.values())
    require(growth_ms > 0, "the profiled train step ran the growth kernels")
    say("profile", f"[{smi}] growth-train kernels {growth_ms:.3f} ms a step, share "
        f"{growth_ms / total_ms:.3f} of the kernels' time: " + ", ".join(
            f"{k} {v:.3f}" for k, v in growth.items()))
    for e in sorted(kernels, key=lambda e: -device_us(e))[:10]:
        say("profile", f"  {device_us(e) / 1e3 / steps:8.3f} ms/step {e.count // steps:4d}x "
            f"{e.key[:110]}")
    return total_ms, wall_ms


def profile_serving(torch, smi, step, clean, steps: int = 5):
    """``torch.profiler`` over ``steps`` serving steps at B=128·256² after a
    warm-up: device time a step, busy share, and the shares of the growth
    layers, the transition, the entry pass, the bilinear upsample, the
    convolutions (cuDNN) and the rest (glue)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(6)
    step(clean, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(clean, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    groups = {"growth": ("growth_wgmma",), "transition": ("transition_wgmma",),
              "entry": ("nchw_to_nhwc", "nhwc_to_slot"), "upsample": ("upsample",),
              "convs": ("conv", "xmma", "cudnn", "implicit_gemm", "gemm")}
    shares = dict.fromkeys([*groups, "glue"], 0.0)
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        name = e.key.lower()
        kind = next((k for k, keys in groups.items() if any(s in name for s in keys)), "glue")
        shares[kind] += device_us(e) / 1e3 / steps
    total = sum(shares.values())
    require(total > 0, "the profiler saw device time")
    say("profile", f"[{smi}] serving step B={BENCH_BATCH}x{BENCH_SIZE}^2 bf16 under torch.profiler "
        f"({steps} steps): {total:.3f} ms of kernels a step, {wall_ms:.3f} ms wall, busy share "
        f"{total / wall_ms:.3f}; " + ", ".join(f"{k} {v:.3f} ms ({v / total:.1%})"
                                              for k, v in shares.items()))
    return shares


def bound(flops: float, nbytes: float, peak: str = "bf16"):
    """(least ms, what binds it): the larger of FLOPs over the card's peak
    for the operands' type and bytes (each input read once, each output
    written once) over HBM's rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def dense_block_work(shapes, io_bytes=2):
    """FLOPs and bytes of inference DenseBlocks (growth 16, 4 layers):
    ``shapes`` = [(batch, c_in, h, w)], bf16 weights, x-dtype I/O."""
    flops = nbytes = 0
    for bsz, c, h, w in shapes:
        p = bsz * h * w
        cs = [c + 16 * i for i in range(4)]
        flops += sum(2 * p * 9 * ci * 16 for ci in cs) + 2 * p * (c + 64) * c
        nbytes += 2 * p * c * io_bytes + sum(16 * ci * 9 * 2 + ci * 8 + 64 for ci in cs)
        nbytes += (c + 64) * c * 2 + (c + 64) * 8 + c * 4
    return flops, nbytes


def dense_block_traffic(shapes, io_bytes=2, growth=16, layers=4) -> float:
    """Bytes the DenseBlock kernels must move between HBM and the SMs, each
    launch reading and writing its operands once: the entry pass reads x and
    writes slot 0 (c_in padded to 8); growth layer i reads the buffer's
    first c_in_pad + 16·i channels and writes its 16; the transition reads
    the buffer and writes the output.  ``shapes`` = [(batch, c_in, h, w)]."""
    total = 0
    for bsz, c, h, w in shapes:
        c_pad = -(-c // 8) * 8
        c_buf = c_pad + growth * layers
        per_pixel = c * io_bytes + 2 * c_pad
        per_pixel += sum(2 * (c_pad + growth * i) + 2 * growth for i in range(layers))
        per_pixel += 2 * c_buf + c * io_bytes
        total += bsz * h * w * per_pixel
    return total


def growth_train_work(backward: bool):
    """FLOPs and bytes of the 16 growth layers of a B=16·256x384 train step,
    f32 I/O, bf16 weights: the forward reads x, writes g; the backward reads
    x and the cotangent, writes dx, da, db, dw (twice the forward's FLOPs)."""
    flops = nbytes = 0
    for _, c_in, (h, w) in GT_BLOCKS:
        p = TRAIN_BATCH * h * w
        for i in range(4):
            c = c_in + 16 * i
            flops += 2 * p * 9 * c * 16 * (2 if backward else 1)
            params = 16 * c * 9 * 2 + 2 * c * 4
            nbytes += (p * c * 4 + p * 16 * 4 + p * c * 4 + 2 * c * 4 + 16 * c * 9 * 4 + params
                       if backward else p * c * 4 + p * 16 * 4 + params + 64)
    return flops, nbytes


def conv_work(shapes, pool=False):
    """FLOPs and bytes of bf16 3x3 convs: ``shapes`` = [(batch, c_in, c_out, h, w)]."""
    flops = nbytes = 0
    for bsz, ci, co, h, w in shapes:
        p = bsz * h * w
        flops += 2 * p * 9 * ci * co
        nbytes += p * ci * 2 + (p // 4 if pool else p) * co * 2 + co * ci * 9 * 2 + co * 4
    return flops, nbytes


def probe_work() -> dict:
    """(FLOPs, bytes, peak) of the probe kernels at the probes' shapes: the
    GEMM reads a and b and writes o; the transposes and products read x (and
    M) and write o."""
    from multi_degradation_image_enhancement_tpu_torch.benchmarks import (
        exp_int8_reprobe as mm, exp_io_transpose as io,
    )

    flops = 2 * mm.M * mm.K * mm.N * mm.BLOCKS
    operands = mm.BLOCKS * (mm.M * mm.K + mm.K * mm.N)
    outs = mm.BLOCKS * mm.M * mm.N
    x_bytes = io.B * io.P * io.C * 2
    product = (2 * io.B * io.P * io.C * io.C, 2 * x_bytes + io.C * io.C * 2, "bf16")
    return {"probe_matmul_bf16": (flops, operands * 2 + outs * 2, "bf16"),
            "probe_matmul_int8": (flops, operands + outs * 4, "int8"),
            "m_dot_xt": product, "xt_dot_m": product, "transpose": (0, 2 * x_bytes, "bf16")}


def library_conv_ms(torch, model):
    """One PyTorch call per CM conv shape for #8's function: bf16
    ``F.conv2d`` (cuDNN) + ReLU on the same inputs and folded weights."""
    import torch.nn.functional as F

    _, convs = _conv_pairs(torch, model)
    total = 0.0
    for _, pack, x in convs:
        b16 = pack.bias.to(torch.bfloat16)
        total += cuda_ms(lambda: torch.relu(F.conv2d(x, pack.w_bf16, b16, padding=1)), 10)
    return total


def phase_probes(torch, smi):
    """Phase 23: the probe kernels #11-#14 at the probes' shapes, each held
    against its plain version: the int8 GEMM and the transposes (``M = I``
    for #12/#13) bit for bit; #12/#13 with a seeded random M (U(-1, 1)) within
    one bf16 ulp of the largest output (2**-7 * max|ref|), and both checks
    again at ``RAGGED_PRODUCTS``; the bf16 GEMM on positive operands within
    2 bf16 ulp relative (|d| <= 2**-6 * |ref|); both GEMM types at 3 x
    [256,96] @ [96,384] too (ragged K and N tiles).  Then the main path:
    both probe scripts with every count reset before.  Returns per kernel
    its error, plain ms, kernel ms, library ms, launches."""
    from multi_degradation_image_enhancement_tpu_torch.benchmarks import (
        exp_int8_reprobe, exp_io_transpose,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_matmul import (
        probe_matmul, probe_matmul_plain,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_transpose import (
        m_dot_xt, m_dot_xt_plain, transpose, transpose_plain, xt_dot_m, xt_dot_m_plain,
    )

    rec = {}
    for label, dtype in exp_int8_reprobe.DTYPES.items():
        a, b = exp_int8_reprobe.make_operands(dtype)
        got, ref = probe_matmul(a, b), probe_matmul_plain(a, b)
        torch.cuda.synchronize()
        d = (got.float() - ref.float()).abs()
        name = "probe_matmul_int8" if dtype == torch.int8 else "probe_matmul_bf16"
        if dtype == torch.int8:
            detail = f"exact {torch.equal(got, ref)}"
            require(torch.equal(got, ref), "int8 GEMM equals its plain version")
        else:
            rel = (d / ref.float().abs()).max().item()
            detail = f"max rel {rel:.3e} (limit 2**-6 = {2.0**-6:.3e}, 2 bf16 ulp)"
            require(bool((d <= 2.0**-6 * ref.float().abs()).all()), "bf16 GEMM within 2 ulp")
        rec[name] = {"max_abs_err": d.max().item(), "plain_ms": cuda_ms(
            lambda: probe_matmul_plain(a, b), 3)}
        say("probes", f"#11 {label} {tuple(a.shape)} @ {tuple(b.shape)}: kernel vs plain max abs "
            f"{d.max().item():.3e}, {detail}")
        del a, b, got, ref, d
    g = torch.Generator(device="cuda").manual_seed(11)
    a, b = (torch.randint(-128, 128, s, generator=g, device="cuda", dtype=torch.int8)
            for s in ((3, 256, 96), (3, 96, 384)))
    require(torch.equal(probe_matmul(a, b), probe_matmul_plain(a, b)),
            "int8 GEMM equals its plain version at 3 x [256,96] @ [96,384]")
    a, b = (torch.rand(s, generator=g, device="cuda").to(torch.bfloat16)
            for s in ((3, 256, 96), (3, 96, 384)))
    got, ref = probe_matmul(a, b).float(), probe_matmul_plain(a, b).float()
    require(bool(((got - ref).abs() <= 2.0**-6 * ref.abs()).all()),
            "bf16 GEMM within 2 ulp at 3 x [256,96] @ [96,384]")
    say("probes", "#11 int8 (3, 256, 96) @ (3, 96, 384): exact; bf16 (positive operands): "
        f"max rel {((got - ref).abs() / ref.abs()).max().item():.3e} (limit 2**-6, 2 bf16 ulp)")

    x, eye = exp_io_transpose.probe_inputs()
    g = torch.Generator(device="cuda").manual_seed(23)
    m_rand = (torch.rand((64, 64), generator=g, device="cuda") * 2 - 1).to(torch.bfloat16)
    xr = torch.rand(x.shape, generator=g, device="cuda").to(torch.bfloat16)
    for name, kern, plain, lib, xi, xm in (
            ("m_dot_xt", m_dot_xt, m_dot_xt_plain, lambda v, m: torch.matmul(m, v.transpose(1, 2)),
             x, xr),
            ("xt_dot_m", xt_dot_m, xt_dot_m_plain, lambda v, m: torch.matmul(v.transpose(1, 2), m),
             x.transpose(1, 2).contiguous(), xr.transpose(1, 2).contiguous())):
        got = kern(xi, eye)
        require(torch.equal(got, plain(xi, eye)) and torch.equal(got, xi.transpose(1, 2)),
                f"{name} with M = I is the transpose, bit for bit")
        got, ref = kern(xm, m_rand).float(), plain(xm, m_rand).float()
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        say("probes", f"{name} {tuple(xi.shape)} bf16: M = I bit-exact; random M max abs {err:.3e} "
            f"(limit 2**-7 * {scale:.3f} = {2.0**-7 * scale:.3e})")
        require(err <= 2.0**-7 * scale, f"{name} with a random M vs plain")
        rec[name] = {"max_abs_err": err, "plain_ms": cuda_ms(lambda: plain(xi, eye), 5),
                     "library_ms": cuda_ms(lambda: lib(xi, eye), 20)}
        del got, ref
    for bsz, p in RAGGED_PRODUCTS:
        for name, kern, plain, shape in (("m_dot_xt", m_dot_xt, m_dot_xt_plain, (bsz, p, 64)),
                                         ("xt_dot_m", xt_dot_m, xt_dot_m_plain, (bsz, 64, p))):
            xi = torch.rand(shape, generator=g, device="cuda").to(torch.bfloat16)
            got = kern(xi, eye)
            require(torch.equal(got, plain(xi, eye)) and torch.equal(got, xi.transpose(1, 2)),
                    f"{name} {shape} with M = I is the transpose, bit for bit")
            got, ref = kern(xi, m_rand).float(), plain(xi, m_rand).float()
            err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
            say("probes", f"{name} {shape} bf16: M = I bit-exact; random M max abs {err:.3e} "
                f"(limit 2**-7 * {scale:.3f} = {2.0**-7 * scale:.3e})")
            require(err <= 2.0**-7 * scale, f"{name} {shape} with a random M vs plain")
            del xi, got, ref
    require(torch.equal(transpose(x), transpose_plain(x)), "transpose bit for bit")
    say("probes", f"transpose {tuple(x.shape)} bf16: bit-exact")
    rec["transpose"] = {"max_abs_err": 0.0, "plain_ms": cuda_ms(lambda: transpose_plain(x), 20)}
    del xr
    torch.cuda.synchronize()

    probe_matmul.launches = m_dot_xt.launches = xt_dot_m.launches = transpose.launches = 0
    mm = exp_int8_reprobe.run(PROBE_ITERS)
    io = exp_io_transpose.run(PROBE_ITERS)
    torch.cuda.synchronize()
    launches = {"probe_matmul": probe_matmul.launches, "m_dot_xt": m_dot_xt.launches,
                "xt_dot_m": xt_dot_m.launches, "transpose": transpose.launches}
    say("probes", f"[{smi}] probe scripts' launches {launches}")
    require(all(n > 0 for n in launches.values()), "each probe kernel ran in the probe scripts")
    require(sum(r["launches"] for r in mm.values()) == launches["probe_matmul"],
            "the GEMM's launches are the two type sets'")
    for route in ("rhsT identity-dot", "lhsT identity-dot", "in-kernel .T"):
        require(io[route]["ok"], f"probe check {route}")
    for label, name in (("bf16->f32", "probe_matmul_bf16"), ("int8->i32", "probe_matmul_int8")):
        rec[name].update(ms=mm[label]["kernel_ms"], library_ms=mm[label]["library_ms"],
                         launches=mm[label]["launches"])
    for route, name in (("rhsT identity-dot", "m_dot_xt"), ("lhsT identity-dot", "xt_dot_m"),
                        ("in-kernel .T", "transpose")):
        rec[name].update(ms=io[route]["ms"], launches=launches[name])
    rec["transpose"]["library_ms"] = io["library transpose"]["ms"]
    work, copy_ms = probe_work(), io["copy (bw ref)"]["ms"]
    for name in ("m_dot_xt", "xt_dot_m"):
        r = rec[name]
        b_ms, b_by = bound(*work[name])
        say("probes", f"[{smi}] {name}: kernel {r['ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms "
            f"(kernel/library {r['ms'] / r['library_ms']:.3f}), bound {b_ms:.4f} ms by {b_by} "
            f"(share {b_ms / r['ms']:.1%}), copy (bw ref) {copy_ms:.4f} ms")
    return rec


def _pipeline_artifacts(torch, work: Path) -> dict:
    """Phase 24's files: nine full-width CDAN experts (``live_cdan``
    statistics, seeds 100-108, so the experts answer differently), 64 PNGs at
    256x384 (procedural clean images, image i put through degradation
    i mod 9 on the CPU), and a full-width classifier whose class head is set
    from its own bf16 features of these images: class c's logit is 3 z_c
    + a_c, z_c a standardised random projection of the feature, a_c placing
    the threshold 0.5 at z_c's 60th percentile for noise and its 93rd for
    the others.  So about two images in five clear noise (more than top1's
    capacity of 8 a batch of 32: drops), and the rest mostly clear nothing
    (clean passthrough)."""
    from PIL import Image

    from multi_degradation_image_enhancement_tpu_torch.classification.model import (
        IMAGENET_MEAN, IMAGENET_STD, init_classifier, serving_classifier,
    )
    from multi_degradation_image_enhancement_tpu_torch.classification.train import save_checkpoint
    from multi_degradation_image_enhancement_tpu_torch.data.dataset import _list_images
    from multi_degradation_image_enhancement_tpu_torch.data.streaming import decode_chunk
    from multi_degradation_image_enhancement_tpu_torch.data.synthetic import _procedural_clean
    from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import save_weights
    from multi_degradation_image_enhancement_tpu_torch.ops import degradations as deg
    from multi_degradation_image_enhancement_tpu_torch.run_pipeline import to_01

    wdir, img_dir = work / "weights", work / "images"
    wdir.mkdir(parents=True)
    img_dir.mkdir()
    names = list(deg.DEGRADATIONS)
    for i, name in enumerate(names):
        save_weights(str(wdir / f"CDAN_{name}.pt"), live_cdan(torch, 100 + i))
    clean = torch.from_numpy(_procedural_clean(PIPE_IMAGES, *EVAL_HW, seed=24)).float()
    for i, name in enumerate(names):
        idx = list(range(i, PIPE_IMAGES, len(names)))
        gen = torch.Generator().manual_seed(200 + i)
        params = deg.sample_params(name, gen, len(idx))
        if name == "noise":
            params["normal"] = torch.randn((len(idx), *EVAL_HW, 3), generator=gen)
        out = deg.apply_with_params(name, clean[idx], params).clamp(0, 255).round().to(torch.uint8)
        for j, k in enumerate(idx):
            Image.fromarray(out[j].numpy()).save(img_dir / f"img{k:02d}_{name}.png")

    clf = init_classifier(torch.Generator().manual_seed(25), len(names), pretrained_backbone=False)
    serv = serving_classifier(clf, torch.bfloat16, "cuda")
    files = _list_images(str(img_dir))
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")
    feats = []
    with torch.inference_mode():
        for i in range(0, len(files), PIPE_BATCH):
            u8 = decode_chunk([str(img_dir / f) for f in files[i:i + PIPE_BATCH]], EVAL_HW)
            feats.append(serv.backbone((to_01(u8, "cuda") - mean) / std).float().cpu())
    feats = torch.cat(feats)
    w = torch.randn((len(names), 512), generator=torch.Generator().manual_seed(26))
    u = feats @ w.T
    mu, sd = u.mean(dim=0), u.std(dim=0)
    z = (u - mu) / sd
    q = torch.tensor([0.60 if n == "noise" else 0.93 for n in names])
    a = -3.0 * torch.stack([torch.quantile(z[:, c], q[c]) for c in range(len(names))])
    with torch.no_grad():
        clf.head_cls.weight.copy_(3.0 * w / sd[:, None])
        clf.head_cls.bias.copy_(a - 3.0 * mu / sd)
    clf_path = work / "classifier.pt"
    save_checkpoint(str(clf_path), clf, {"classes": names})
    (work / "thresholds_val.json").write_text(json.dumps({"thresholds": dict.fromkeys(names, 0.5)}))
    say("pipeline", f"wrote 9 experts, {len(files)} PNGs {EVAL_HW[0]}x{EVAL_HW[1]} and the "
        f"classifier; feature projections: std {sd.min().item():.3e}..{sd.max().item():.3e}")
    labels = [names[int(f[3:5]) % len(names)] for f in files]  # img{k:02d}_<name>.png
    return {"weights": wdir, "images": img_dir, "classifier": clf_path, "files": files,
            "labels": labels}


def phase_pipeline(torch, smi):
    """Phase 24: the CLI ``run_pipeline`` restores the 64 PNGs on the card
    (B=32, nine experts, bf16), in top1 and in severity-ordered sequential
    mode.  Each mode runs it in-process through ``run_pipeline.main`` with
    the DenseBlock and expert-forward counts reset just before (no DenseBlock
    launch: the experts are the eval module, as in the JAX pipeline; and the
    forwards its own probabilities call for), and as a subprocess (``python
    -m``); both runs' PNGs within 1
    LSB of an in-process ``FullPipeline`` on the same decoded batches, the
    same route for each image, top1 showing routed, clean and dropped images.
    Then the step timed as ``benchmarks/bench_pipeline.py`` times it
    (classifier, bank, whole step, img/s) on the first batch, routed by the
    images' own labels: each image to the expert of the degradation it
    carries (nine forwards a batch, no drop); the class head above serves
    only the route checks."""
    import io
    import shutil

    import numpy as np
    from PIL import Image

    from multi_degradation_image_enhancement_tpu_torch import run_pipeline
    from multi_degradation_image_enhancement_tpu_torch.benchmarks.bench_pipeline import (
        expert_forwards, time_step,
    )
    from multi_degradation_image_enhancement_tpu_torch.data.streaming import decode_chunk
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import dense_block
    from multi_degradation_image_enhancement_tpu_torch.pipeline import CLEAN, DROPPED
    from multi_degradation_image_enhancement_tpu_torch.run_pipeline import (
        build_full_pipeline, to_01, to_u8,
    )

    work = Path("build") / "chip_smoke_pipeline"
    shutil.rmtree(work, ignore_errors=True)
    art = _pipeline_artifacts(torch, work)
    files = art["files"]
    batches = [decode_chunk([str(art["images"] / f) for f in files[i:i + PIPE_BATCH]], EVAL_HW)
               for i in range(0, len(files), PIPE_BATCH)]
    xs = [to_01(u8, "cuda") for u8 in batches]
    ran = [0]
    load_expert_bank = run_pipeline.load_expert_bank

    def load_counted(*args):
        names, forwards = load_expert_bank(*args)

        def counted(forward):
            def run(x):
                ran[0] += 1
                return forward(x)
            return run
        return names, [counted(f) for f in forwards]

    records = {}
    for mode, ordering in (("top1", "fixed"), ("sequential", "severity")):
        def argv(out):
            return ["--images", str(art["images"]), "--out", str(out), "--classifier",
                    str(art["classifier"]), "--weights-dir", str(art["weights"]), "--batch",
                    str(PIPE_BATCH), "--input-hw", str(EVAL_HW[0]), str(EVAL_HW[1]),
                    "--save-probs", "--mode", mode, "--ordering", ordering]

        # The main path: the CLI in-process, every count reset just before it.
        out_main = work / f"main_{mode}"
        run_pipeline.load_expert_bank = load_counted
        log = io.StringIO()
        try:
            torch.cuda.synchronize()
            dense_block.launches, ran[0] = 0, 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                run_pipeline.main(argv(out_main))
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches, forwards = dense_block.launches, ran[0]
        finally:
            run_pipeline.load_expert_bank = load_expert_bank
        out = work / f"out_{mode}"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PKG}.run_pipeline", *argv(out)],
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"run_pipeline {mode} exits 0:\n{proc.stdout[-1500:]}\n"
                f"{proc.stderr[-3000:]}")

        pipe = build_full_pipeline(str(art["classifier"]), str(art["weights"]), mode, ordering,
                                   "cuda")
        names = pipe.router.expert_names
        probs_of = {}
        for d in (out_main, out):
            rows = [json.loads(line) for line in (d / "probs.jsonl").read_text().splitlines()]
            require([r["file"] for r in rows] == files, f"{d.name}: one probs row per image")
            probs_of[d] = torch.tensor([[r["probs"][n] for n in names] for r in rows])
        main_probs = probs_of[out_main]
        expected = sum(expert_forwards(pipe.router, main_probs[i:i + PIPE_BATCH].cuda(),
                                       pipe.thresholds) for i in range(0, len(files), PIPE_BATCH))
        worst, probs_err, routes = 0, 0.0, []
        with torch.inference_mode():
            for bi, x in enumerate(xs):
                restored, probs = pipe(x)
                got = to_u8(restored)
                require(got.shape == (len(batches[bi]), *EVAL_HW, 3)
                        and bool(torch.isfinite(restored).all()), "outputs")
                chunk = slice(bi * PIPE_BATCH, (bi + 1) * PIPE_BATCH)
                for d in (out_main, out):
                    png = np.stack([np.asarray(Image.open(d / f"{f.rsplit('.', 1)[0]}.png"))
                                    for f in files[chunk]])
                    worst = max(worst, int(np.abs(got.astype(np.int16) - png).max()))
                    probs_err = max(probs_err, (probs.float().cpu() - probs_of[d][chunk]).abs()
                                    .max().item())
                    if mode == "top1":
                        require(torch.equal(pipe.router.route(probs, pipe.thresholds).cpu(),
                                            pipe.router.route(probs_of[d][chunk].cuda(),
                                                              pipe.thresholds).cpu()),
                                f"{d.name}: the CLI's routes are the in-process routes")
                if mode == "top1":
                    routes.append(pipe.router.route(probs, pipe.thresholds).cpu())
        require(len(list(out_main.glob("*.png"))) == len(files)
                and len(list(out.glob("*.png"))) == len(files), "one PNG per image")
        last = log.getvalue().strip().splitlines()[-1]
        msg = (f"{mode}/{ordering}: CLI in-process {main_s:.1f} s ({last}), subprocess "
               f"{cli_s:.1f} s; in-process FullPipeline vs both "
               f"CLIs' PNGs max |d| {worst} LSB (limit 1), probs max |d| {probs_err:.2e}; the "
               f"in-process CLI ran {forwards} expert forwards (its probabilities call for "
               f"{expected}) and {launches} dense_block launches (expected 0: the eval module)")
        rec = {"launches": launches, "expert_forwards": forwards, "cli_s": cli_s}
        if mode == "top1":
            r = torch.cat(routes)
            counts = {"routed": int((r >= 0).sum()), "clean": int((r == CLEAN).sum()),
                      "dropped": int((r == DROPPED).sum())}
            rec.update(counts)
            msg += f"; routes {counts}, drop rate {counts['dropped'] / len(r):.4f}"
            require(all(v > 0 for v in counts.values()), "top1 has routed, clean and dropped images")
        say("pipeline", msg)
        require(worst <= 1, "CLI PNGs within 1 LSB of the in-process pipeline")
        require(forwards > 0 and forwards == expected, "the CLI ran the forwards its routes call for")
        require(launches == 0, "no DenseBlock launch: the experts run the eval module")

        # Timed on labelled traffic: each image routed to its own degradation's expert.
        first = art["labels"][:PIPE_BATCH]
        label = torch.tensor([[0.9 if lab == n else 0.1 for n in names] for lab in first],
                             device="cuda")
        lab_routes = pipe.router.route(label, pipe.thresholds)
        t = time_step(pipe, xs[0], 10, probs=label)
        t["drop_rate"] = int((lab_routes == DROPPED).sum()) / len(first)
        rec["timed"] = t
        say("times", f"[{smi}] pipeline {mode}/{ordering} B={PIPE_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} "
            f"bf16, 9 experts, routed by the images' labels ({t['expert_forwards']} expert "
            f"forwards, drop rate {t['drop_rate']:.4f}): classifier {t['classify_ms']:.3f} ms, "
            f"bank {t['bank_ms']:.3f} ms, step {t['pipeline_ms']:.3f} ms "
            f"({t['pipeline_img_s']:.1f} img/s)")
        records[mode] = rec
    records["routes"] = pipeline_routes(torch, art, xs)
    records["art"] = art
    return records


def pipeline_routes(torch, art, xs):
    """What the bank's route changes: one expert (noise's) over the 64
    images, through the module route ``load_expert_bank`` builds (bf16
    autocast) and through the fused serving forward it used before
    (``build_serving_apply``, bf16), each against the f32 module (TF32 off):
    max and mean |d| and the PSNR of the route's output against the f32
    module's."""
    from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN, eval_forward
    from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply
    from multi_degradation_image_enhancement_tpu_torch.pipeline import load_expert_bank

    path = str(art["weights"] / "CDAN_noise.pt")
    model = load_weights(path, CDAN()).to("cuda").eval()
    ref_fn = eval_forward(model, torch.float32)
    routes = {"module": load_expert_bank({"noise": path}, torch.device("cuda"), torch.bfloat16)[1][0],
              "fused": build_serving_apply(model, torch.bfloat16, torch.device("cuda"))}
    out = {}
    with torch.inference_mode():
        ref = torch.cat([ref_fn(x) for x in xs])
        for name, fn in routes.items():
            d = torch.cat([fn(x).float() for x in xs]) - ref
            mse = (d * d).mean().item()
            out[name] = {"max_abs": d.abs().max().item(), "mean_abs": d.abs().mean().item(),
                         "psnr_db": 10.0 * math.log10(1.0 / mse) if mse > 0 else float("inf")}
            say("pipeline", f"route {name} (bf16) vs the f32 module, noise expert over "
                f"{ref.shape[0]} images: max {out[name]['max_abs']:.3e} mean "
                f"{out[name]['mean_abs']:.3e} PSNR {out[name]['psnr_db']:.2f} dB")
            require(bool(torch.isfinite(d).all()), f"route {name} finite")
    return out


def _clean_pngs(folder: Path, n: int, seed: int):
    """``n`` procedural clean PNGs of odd sizes, some above 256x384 and some
    below it, so the letterbox both shrinks and enlarges."""
    from PIL import Image

    from multi_degradation_image_enhancement_tpu_torch.data.synthetic import _procedural_clean

    folder.mkdir(parents=True)
    for i in range(n):
        h, w = 181 + (97 * i) % 240, 263 + (151 * i) % 330
        Image.fromarray(_procedural_clean(1, h, w, seed=seed + i)[0]).save(folder / f"c{i:03d}.png")


def _train_classifier(torch, argv) -> tuple:
    """``classification.train.main(argv)`` with its console output kept out of
    this script's; returns (summary, thresholds report, seconds)."""
    import io

    from multi_degradation_image_enhancement_tpu_torch.classification import train

    run_dir = Path(argv[argv.index("--run_dir") + 1])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for name in ("training.log", "history.json", "best_model.pt", "best_model.pt.json",
                 "thresholds_val.json", "per_class_f1_val.json", "per_class_f1_test.json",
                 "summary.json"):
        require((run_dir / name).is_file(), f"classifier run wrote {name}")
    require((run_dir / "diagnostics" / "test" / "ap_pr_summary.json").is_file(), "diagnostics")
    report = json.loads((run_dir / "thresholds_val.json").read_text())
    require(all(math.isfinite(v) for v in summary["test"].values()), "test metrics finite")
    require(summary["backend"] == "cuda", "the classifier trained on the card")
    return summary, report, seconds


def phase_classifier(torch, smi):
    """Phase 25: generate a classifier dataset on the card and train on it
    (one epoch, B=32·256x384, no pretrained backbone), then the synthetic
    trainer at ``CLF_SYNTH``'s scale for each seed, gated on the floors."""
    import io
    import shutil

    from multi_degradation_image_enhancement_tpu_torch.classification.data import read_jsonl
    from multi_degradation_image_enhancement_tpu_torch.datasets_generation import (
        generate_classifier,
    )

    work = Path("build") / "chip_smoke_classifier"
    shutil.rmtree(work, ignore_errors=True)
    _clean_pngs(work / "clean", CLF_CLEAN, 500)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        generate_classifier.main(["--clean-dir", str(work / "clean"), "--out", str(work / "dataset")])
    gen_s = time.perf_counter() - t0
    split = json.loads(next((work / "dataset" / "meta").glob("split_*.json")).read_text())
    rows = {k: read_jsonl(str(work / "dataset" / k / "labels.jsonl")) for k in split}
    from PIL import Image

    sizes = {Image.open(work / "dataset" / r["file"]).size for v in rows.values() for r in v}
    say("classifier", f"generate_classifier: {CLF_CLEAN} PNGs -> "
        f"{ {k: len(v) for k, v in rows.items()} } samples in {gen_s:.2f} s, sizes {sizes}")
    require(all(len(rows[k]) == 5 * len(split[k]) for k in split), "5 variants per clean image")
    require(sizes == {(EVAL_HW[1], EVAL_HW[0])}, "every sample letterboxed to 256x384")

    summary, report, secs = _train_classifier(torch, [
        "--dataset_root", str(work / "dataset"), "--no_pretrained", "--epochs", "1",
        "--batch_size", str(CLF_BATCH), "--run_dir", str(work / "run_dataset")])
    say("classifier", f"--dataset_root, 1 epoch B={CLF_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} f32, all four "
        f"stages in {secs:.1f} s: val F1-micro (tuned) {report['val_f1_micro']:.4f}, test "
        f"{summary['test']}")

    cfg = CLF_SYNTH
    results = {}
    for seed in CLF_SEEDS:
        run_dir = work / f"run_synthetic_{seed}"
        summary, report, secs = _train_classifier(torch, [
            "--synthetic", "--no_pretrained", "--seed", str(seed),
            "--synthetic_images", str(cfg["images"]), "--synthetic_variants", str(cfg["variants"]),
            "--epochs", str(cfg["epochs"]), "--batch_size", str(cfg["batch"]),
            "--input_hw", str(cfg["hw"][0]), str(cfg["hw"][1]), "--th_steps", "7",
            "--bn_recal_passes", "2", "--run_dir", str(run_dir)])
        got = {"val_f1_micro": report["val_f1_micro"], "test_f1_micro": summary["test"]["f1_micro"],
               "sev_mae": summary["test"]["sev_mae"]}
        results[seed] = {"run_dir": run_dir, "seconds": secs, **got}
        say("classifier", f"--synthetic seed {seed}, {cfg['images']} images x {cfg['variants']} "
            f"variants, {cfg['epochs']} epochs B={cfg['batch']}x{cfg['hw'][0]}x{cfg['hw'][1]} in "
            f"{secs:.1f} s: val F1-micro (tuned) {got['val_f1_micro']:.4f} (floor 0.35), test "
            f"F1-micro {got['test_f1_micro']:.4f} (floor 0.30), sev MAE {got['sev_mae']:.4f} "
            f"(ceiling 0.30), best epoch {summary['best_epoch']}")
    for seed, r in results.items():
        require(r["val_f1_micro"] >= CLF_FLOORS["val_f1_micro"]
                and r["test_f1_micro"] >= CLF_FLOORS["test_f1_micro"]
                and r["sev_mae"] <= CLF_FLOORS["sev_mae"], f"seed {seed} clears the quality floors")
    return results


def classifier_times(torch, smi):
    """Phase 26: the f32 train step at B=32·256x384 (20 steps after 3 warm-up,
    CUDA events, the synthetic loader's first full batch), the eval step, and
    the synthetic degrade stage of that template batch."""
    from multi_degradation_image_enhancement_tpu_torch.classification import train
    from multi_degradation_image_enhancement_tpu_torch.classification.model import init_classifier
    from multi_degradation_image_enhancement_tpu_torch.classification.synthetic import (
        SyntheticClassifierDataset, SyntheticClassifierLoader, degrade_template,
    )

    ds = SyntheticClassifierDataset(n_images=4 * CLF_BATCH, variants_per_image=1, input_hw=EVAL_HW)
    loader = SyntheticClassifierLoader(ds, CLF_BATCH, shuffle=True, augment=True, device="cuda")
    idxs = next(b for b in loader._batches() if len(b) == CLF_BATCH)
    template, imgs, ys, ss, _ = loader._host_batch(idxs)
    clean = torch.from_numpy(imgs).cuda().float()
    gen = torch.Generator(device="cuda").manual_seed(26)
    degrade_ms = cuda_ms(lambda: degrade_template(clean, template, ys, ss, ds.classes, gen), 20, 3)
    chain = [d for d in ds.classes if (ys[:, ds.classes.index(d)] > 0.5).any()]
    x, y, s, _ = next(iter(loader))
    model = init_classifier(torch.Generator().manual_seed(42), len(ds.classes),
                            pretrained_backbone=False).cuda()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    pw = torch.ones(len(ds.classes), device="cuda")
    step_ms = cuda_ms(lambda: train.train_step(model, opt, x, y, s, pw), 20, 3)
    eval_ms = cuda_ms(lambda: train.eval_step(model, x, y, s, pw), 20, 3)
    profile_classifier(torch, smi, lambda: train.train_step(model, opt, x, y, s, pw))
    say("times", f"[{smi}] classifier train step B={CLF_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} f32 "
        f"({train.tf32_state()}): {step_ms:.3f} ms/step, {CLF_BATCH / step_ms * 1e3:.1f} img/s; "
        f"eval step {eval_ms:.3f} ms ({CLF_BATCH / eval_ms * 1e3:.1f} img/s); synthetic degrade "
        f"stage of one template batch (template {template}, {len(chain)} degradations applied: "
        f"{chain}) {degrade_ms:.3f} ms")
    return {"train_ms": step_ms, "eval_ms": eval_ms, "degrade_ms": degrade_ms}


GEMM_KEYS = ("gemm", "conv", "xmma", "cutlass", "cudnn", "fprop", "dgrad", "wgrad")


def profile_classifier(torch, smi, step, steps: int = 3):
    """``torch.profiler`` over ``steps`` classifier train steps after two
    warm-up ones: device time a step, busy share, the share of the
    convolution and GEMM kernels (names holding one of ``GEMM_KEYS``), and
    the eight kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total_ms = sum(device_us(e) for e in kernels) / 1e3 / steps
    require(total_ms > 0, "the profiler saw device time")
    gemm_ms = sum(device_us(e) for e in kernels
                  if any(k in e.key.lower() for k in GEMM_KEYS)) / 1e3 / steps
    launches = sum(e.count for e in kernels) // steps
    say("profile", f"[{smi}] classifier train step under torch.profiler: {total_ms:.3f} ms of "
        f"kernels a step ({launches} launches), {wall_ms:.3f} ms wall, busy share "
        f"{total_ms / wall_ms:.3f}; convolutions and GEMMs {gemm_ms:.3f} ms (share "
        f"{gemm_ms / total_ms:.3f}), the rest {total_ms - gemm_ms:.3f} ms")
    for e in sorted(kernels, key=lambda e: -device_us(e))[:8]:
        say("profile", f"  {device_us(e) / 1e3 / steps:8.3f} ms/step {e.count // steps:4d}x "
            f"{e.key[:110]}")


def phase_trained_head(torch, smi, art, clf_run: Path):
    """Phase 27: the routed server (CLI ``run_pipeline``, top1, B=32) with
    phase 25's trained head on phase 24's 64 PNGs: top-1 accuracy of the
    class head against each PNG's degradation, and the drop rate; reported,
    not gated."""
    import io
    import shutil

    from multi_degradation_image_enhancement_tpu_torch import run_pipeline
    from multi_degradation_image_enhancement_tpu_torch.pipeline import CLEAN, DROPPED

    out = Path("build") / "chip_smoke_pipeline" / "trained_head"
    shutil.rmtree(out, ignore_errors=True)
    clf = clf_run / "best_model.pt"
    with contextlib.redirect_stdout(io.StringIO()) as log:
        run_pipeline.main(["--images", str(art["images"]), "--out", str(out), "--classifier",
                           str(clf), "--weights-dir", str(art["weights"]), "--batch", str(PIPE_BATCH),
                           "--input-hw", str(EVAL_HW[0]), str(EVAL_HW[1]), "--save-probs"])
    require(f"thresholds: {clf_run / 'thresholds_val.json'}" in log.getvalue(),
            "run_pipeline took the trained run's thresholds_val.json")
    pipe = run_pipeline.build_full_pipeline(str(clf), str(art["weights"]), "top1", "fixed", "cuda")
    names = pipe.router.expert_names
    rows = [json.loads(line) for line in (out / "probs.jsonl").read_text().splitlines()]
    require([r["file"] for r in rows] == art["files"], "one probs row per PNG")
    probs = torch.tensor([[r["probs"][n] for n in names] for r in rows])
    top1 = [names[i] for i in probs.argmax(dim=1).tolist()]
    acc = sum(a == b for a, b in zip(top1, art["labels"])) / len(rows)
    routes = pipe.router.route(probs.cuda(), pipe.thresholds).cpu()
    drop = float((routes == DROPPED).float().mean())
    clean = float((routes == CLEAN).float().mean())
    require(len(list(out.glob("*.png"))) == len(rows), "one restored PNG per image")
    say("pipeline", f"[{smi}] trained head ({clf}, no pretrained backbone) in run_pipeline top1 "
        f"over {len(rows)} PNGs: top-1 route accuracy {acc:.4f} against the PNGs' degradations "
        f"(chance {1 / len(names):.4f}), drop rate {drop:.4f}, clean passthrough {clean:.4f}")
    return {"accuracy": acc, "drop_rate": drop, "clean_rate": clean}


def phase_dir_config(torch, smi):
    """Phase 28: noise pairs from ``generate_paired`` on the card, then
    ``run.main`` ``-p train`` (one epoch of config/noise.json, roots
    rewritten) and ``-p test``, every launch counted; train and test step
    img/s by CUDA events."""
    import io
    import shutil

    from multi_degradation_image_enhancement_tpu_torch import run
    from multi_degradation_image_enhancement_tpu_torch.datasets_generation import generate_paired
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK, dense_block,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd,
    )
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    work = Path("build") / "chip_smoke_dir"
    shutil.rmtree(work, ignore_errors=True)
    _clean_pngs(work / "clean", DIR_IMAGES, 700)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        generate_paired.main(["--clean-dir", str(work / "clean"), "--out", str(work / "data"),
                              "--generate", "noise"])
    gen_s = time.perf_counter() - t0
    n = {k: len(list((work / "data" / "noise" / k / "degraded").glob("*.png")))
         for k in ("train", "test")}
    say("dir_config", f"generate_paired noise: {DIR_IMAGES} PNGs -> {n} pairs at "
        f"{EVAL_HW[0]}x{EVAL_HW[1]} in {gen_s:.2f} s")
    require(sum(n.values()) == DIR_IMAGES, "every clean image paired")

    cfg = read_config("noise")
    cfg["train"].update(n_epoch=1, model_path=str(work / "weights"))
    cfg["test"].update(model_path=str(work / "weights"), output_images_path=str(work / "outputs"))
    for split in ("train", "test"):
        args = cfg[split]["dataset"]["args"]
        args["input_root"] = str(work / "data" / "noise" / split / "degraded")
        args["target_root"] = str(work / "data" / "noise" / split / "clean")
    cfg["save_outputs"]["output_dir"] = str(work / "outputs")
    cfg["logging"]["root_dir"] = str(work / "runs")
    (work / "config.json").write_text(json.dumps(cfg))
    bsz = cfg["train"]["dataloader"]["args"]["batch_size"]
    steps, passes = -(-n["train"] // bsz), cfg["train"]["bn_recalibration"]["passes"]

    growth_layer_fwd.launches = growth_layer_bwd.launches = dense_block.launches = 0
    t0 = time.perf_counter()
    engine = run.main(load_config(str(work / "config.json"), phase="train"))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {"growth_train_fwd": growth_layer_fwd.launches,
                      "growth_train_bwd": growth_layer_bwd.launches,
                      "dense_block": dense_block.launches}
    (csv_path,) = (work / "runs").glob("noise/*/train.csv")
    header, row = csv_path.read_text().splitlines()
    loss = float(dict(zip(header.split(","), row.split(",")))["loss_total"])
    inputs, targets, mask = next(iter(engine.dataloader))
    gen = torch.Generator(device="cuda").manual_seed(28)
    step_ms = cuda_ms(lambda: engine._train_step(engine.state, inputs, targets, gen, mask), 10, 3)

    dense_block.launches = 0
    t0 = time.perf_counter()
    tester = run.main(load_config(str(work / "config.json"), phase="test"))
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = dense_block.launches
    (csv_path,) = (work / "runs").glob("noise/*/test.csv")
    header, row = csv_path.read_text().splitlines()
    scores = {k: float(v) for k, v in zip(header.split(","), row.split(","))
              if k.startswith(("loss_", "metric_"))}
    eval_step = tester._build_eval_step(tester._load_for_eval())
    t_in, t_tgt, t_mask = next(iter(tester.dataloader))
    eval_ms = cuda_ms(lambda: eval_step(t_in, t_tgt, t_mask), 10, 3)
    test_batches = -(-n["test"] // cfg["test"]["dataloader"]["args"]["batch_size"])
    pngs = len(list((work / "outputs").glob("raw_*.png")))
    say("dir_config", f"[{smi}] noise.json -p train: {steps} steps B={bsz}x{EVAL_HW[0]}x{EVAL_HW[1]} "
        f"{engine.precision} + {passes} recalibration passes in {train_s:.1f} s, epoch loss "
        f"{loss:.5f}, launches {train_launches}; train step {step_ms:.3f} ms "
        f"({bsz / step_ms * 1e3:.1f} img/s)")
    say("dir_config", f"[{smi}] noise.json -p test: {n['test']} pairs in {test_s:.2f} s, {pngs} PNGs, "
        f"scores {scores}, dense_block launches {test_launches}; eval step {eval_ms:.3f} ms per "
        f"B={bsz} batch ({bsz / eval_ms * 1e3:.1f} img/s)")
    require(math.isfinite(loss) and engine.network.fused_dense, "finite loss, fused DenseBlocks")
    require(train_launches["growth_train_fwd"] == 16 * steps * (1 + passes)
            and train_launches["growth_train_bwd"] == 16 * steps, "growth-train launches (#4-#7)")
    require(train_launches["dense_block"] == 0, "training runs no inference DenseBlock")
    require(test_launches == 4 * LAUNCHES_PER_BLOCK * test_batches, "DenseBlock launches (#2)")
    require(pngs == n["test"] and all(math.isfinite(v) for v in scores.values()), "test outputs")
    return {"train_launches": train_launches, "test_launches": test_launches,
            "train_ms": step_ms, "eval_ms": eval_ms}


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
    live = live_cdan(torch, 0)
    phase_forward(torch, live)
    launches, step, bench_clean, eval_clean = phase_requests(torch)
    times = phase_times(torch, smi, step, bench_clean, eval_clean, packs, model)
    profile_serving(torch, smi, step, bench_clean)
    gt_err = phase_growth_train(torch)
    phase_train_step(torch)
    gt_launches, engine = phase_cli_train(torch)
    noise_train_ms = train_times(torch, smi, engine)
    gt_ms = growth_times(torch, smi)
    conv_err = phase_conv_kernels(torch, live)
    phase_cm_forward(torch, live)
    tiled_err = phase_tiled_shapes(torch, live)
    cm_launches, step_cm, step_k, clean = phase_requests_cm(torch)
    shipped, cm_run, photo = phase_cli_test(torch, engine)
    cm_ms = eval_times(torch, smi, live, shipped, step_cm, step_k, clean)
    fdb_err, fdb_launches, fdb_ms = phase_fused_dense_block(torch, smi, model)
    phase_degradations(torch, smi)
    records = phase_cli_configs(torch)
    with tf32_defaults(torch) as flags:  # the perceptual nets' f32 convs run as the CLI runs them
        say("times", f"jpeg_synthetic step with {flags}")
        perceptual_times(torch, smi, records["jpeg_synthetic"]["engine"], noise_train_ms)
        profile_step(torch, smi, engine)
        profile_step(torch, smi, records["jpeg_synthetic"]["engine"])
    conv_lib_ms = library_conv_ms(torch, live)
    probes = phase_probes(torch, smi)
    pipe_records = phase_pipeline(torch, smi)
    with tf32_defaults(torch) as flags:  # the classifier trainer as a user runs it
        say("classifier", f"phases 25 and 26 with {flags}")
        clf_runs = phase_classifier(torch, smi)
        classifier_times(torch, smi)
    phase_trained_head(torch, smi, pipe_records["art"], clf_runs[CLF_SEEDS[0]]["run_dir"])
    with tf32_defaults(torch) as flags:  # the directory config's CLI as a user runs it
        say("dir_config", f"phase 28 with {flags}")
        phase_dir_config(torch, smi)

    src = f"{PKG}/csrc"
    ref = "multi_degradation_image_enhancement_tpu/ops/pallas"
    n_noise = BENCH_BATCH * BENCH_SIZE * BENCH_SIZE * 3
    eval_blocks = [(bsz, c, h, w) for _, bsz, c, (h, w) in DB_SHAPES[4:]]
    work = {  # (FLOPs, bytes, peak) of the work each kernel's "ms" times
        "noise_degrade": (20 * n_noise, n_noise * (4 + 2) + BENCH_BATCH * 4, "f32"),
        "dense_block": (*dense_block_work([(bsz, c, h, w) for _, bsz, c, (h, w) in DB_SHAPES[:4]]),
                        "bf16"),
        "growth_train_fwd": (*growth_train_work(False), "bf16"),
        "growth_train_bwd": (*growth_train_work(True), "bf16"),
        "conv3x3_pool": (*conv_work([(BENCH_BATCH, 3, 64, BENCH_SIZE, BENCH_SIZE)], pool=True), "bf16"),
        "conv3x3": (*conv_work([(BENCH_BATCH, ci, co, h, w) for _, ci, co, (h, w) in CM_CONVS]), "bf16"),
        "dense_block_tiled": (*dense_block_work([(EVAL_BATCH, 3, *PHOTO_HW)]), "bf16"),
        "fused_dense_block": (*dense_block_work(eval_blocks), "bf16"),
        **probe_work(),
    }
    kernels = [
        {"name": "noise_degrade", "route": "cuda", "source": f"{src}/noise.cu",
         "replaces": f"{ref}/noise.py:75", "launches": launches["noise_degrade"],
         "max_abs_err": noise_err, "ms": times["noise_degrade"][0],
         "plain_ms": times["noise_degrade"][1], "library_ms": None},
        {"name": "dense_block", "route": "cuda", "source": f"{src}/dense_block.cu",
         "replaces": f"{ref}/dense_block_cm.py:452", "launches": launches["dense_block"],
         "max_abs_err": db_err, "ms": times["dense_block"][0],
         "plain_ms": times["dense_block"][1], "library_ms": None,
         "module_route_ms": times["dense_block_module_ms"]},
        {"name": "growth_train_fwd", "route": "cuda", "source": f"{src}/growth_train.cu",
         "replaces": f"{ref}/growth_train.py:86",  # and its tiled variant, :288
         "launches": gt_launches["growth_train_fwd"], "max_abs_err": gt_err["fwd"],
         "ms": gt_ms["fwd"], "plain_ms": gt_ms["plain_fwd"], "library_ms": None,
         "module_route_ms": gt_ms["module_fwd"]},
        {"name": "growth_train_bwd", "route": "cuda", "source": f"{src}/growth_train.cu",
         "replaces": f"{ref}/growth_train.py:178",  # and its tiled variant, :345
         "launches": gt_launches["growth_train_bwd"], "max_abs_err": gt_err["bwd"],
         "ms": gt_ms["bwd"], "plain_ms": gt_ms["plain_bwd"], "library_ms": None,
         "module_route_ms": gt_ms["module_bwd"]},
        {"name": "conv3x3_pool", "route": "cuda", "source": f"{src}/conv_cm.cu",
         "replaces": f"{ref}/conv_pool_cm.py:100", "launches": cm_run["launches"]["conv3x3_pool"],
         "max_abs_err": conv_err["conv3x3_pool"], "ms": cm_ms["conv3x3_pool"][0],
         "plain_ms": cm_ms["conv3x3_pool"][1], "library_ms": None,
         "module_route_ms": cm_ms["conv3x3_pool_module_ms"]},
        {"name": "conv3x3", "route": "cuda", "source": f"{src}/conv_cm.cu",
         "replaces": f"{ref}/conv_cm.py:49", "launches": cm_launches["kernel"]["conv3x3"],
         "max_abs_err": conv_err["conv3x3"], "ms": cm_ms["conv3x3"][0],
         "plain_ms": cm_ms["conv3x3"][1], "library_ms": conv_lib_ms},
        {"name": "dense_block_tiled", "route": "cuda", "source": f"{src}/dense_block.cu",
         "replaces": f"{ref}/dense_block_cm.py:111", "launches": photo["launches"]["dense_block"],
         "max_abs_err": tiled_err, "ms": cm_ms["dense_block_tiled"][0],
         "plain_ms": cm_ms["dense_block_tiled"][1], "library_ms": None},
        {"name": "fused_dense_block", "route": "cuda", "source": f"{src}/dense_block.cu",
         "replaces": f"{ref}/dense_block.py:56", "launches": fdb_launches,
         "max_abs_err": fdb_err, "ms": fdb_ms["kernel"], "plain_ms": fdb_ms["plain"],
         "library_ms": None},
    ]
    for name, source, replaces in (
            ("probe_matmul_bf16", "probe_matmul.cu", "benchmarks/exp_int8_reprobe.py:39"),
            ("probe_matmul_int8", "probe_matmul.cu", "benchmarks/exp_int8_reprobe.py:39"),
            ("m_dot_xt", "probe_transpose.cu", "benchmarks/exp_io_transpose.py:40"),
            ("xt_dot_m", "probe_transpose.cu", "benchmarks/exp_io_transpose.py:50"),
            ("transpose", "probe_transpose.cu", "benchmarks/exp_io_transpose.py:60")):
        r = probes[name]
        kernels.append({"name": name, "route": "cuda", "source": f"{src}/{source}",
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "library_ms": r["library_ms"]})
    for k in kernels:
        flops, nbytes, peak = work[k["name"]]
        k["bound_ms"], k["bound_by"] = bound(flops, nbytes, peak)
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.3f} ms"
        if "module_route_ms" in k:
            lib += f", module route {k['module_route_ms']:.3f} ms"
        say("bounds", f"[{smi}] {k['name']}: {flops / 1e9:.1f} GFLOP ({peak}), {nbytes / 1e9:.3f} GB "
            f"-> bound {k['bound_ms']:.4f} ms by {k['bound_by']}; kernel {k['ms']:.3f} ms "
            f"(roofline share {k['bound_ms'] / k['ms']:.1%}), plain {k['plain_ms']:.3f} ms, "
            f"library {lib}, launches {k['launches']}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
