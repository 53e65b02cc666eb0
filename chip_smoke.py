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
   B=16·256×384), with launch counters showing the noise, DenseBlock,
   conv and CBAM kernels ran (one #9, seven #8 launches and four fused CBAM
   calls a step);
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
    2×256×384, every conv after conv1 on #8;
14. the DenseBlock kernel at the block shapes where the JAX package takes
    its row-tiled kernel (#3), ``fused_dense_block_cm`` once, and the
    per-block forward at 2×480×640 vs the f32 ``CDAN``;
15. serving steps at B=128·256² with launch counters (the served CM
    forward: one #9, seven #8 launches and four fused CBAM calls a step);
16. ``run.main`` ``-p test`` on noise_synthetic.json's test block cut to 64
    images, scoring the checkpoint of phase 10: at 256×384 (the pinned
    tuning) and with the test images resized to 480×640 (the #3 route);
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
    ``FullPipeline`` (1 LSB), whole DenseBlocks launched (on the card the
    experts run the hand-kernel serving forward, as CUDA graphs), the three
    top1 cases (routed, clean, dropped), the step's times and drop rate with
    each image routed by its own degradation, and one expert's bank route
    and eval module under a bf16 autocast against the f32 module;
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
    (#2) launches counted; train and test step img/s;
29. the remat step: noise_synthetic's fused train step at B=16·256×384 with
    ``remat`` off and on (same weights, batch and dropout masks, cuDNN
    deterministic), bf16 and fp32: loss and running statistics bit-equal, the
    recomputation under the bf16 autocast, 32 growth forwards and 16
    backwards under remat; the gradients (the worst leaf's relative L2)
    within twice the widest distance of five repeats of the plain step from
    it (the card's step is not reproducible to 1e-5); each step's peak
    memory (remat must lower it) and ms (CUDA events);
30. the rest of training through the CLI: ``run.main`` on noise_synthetic.json
    cut to 2 epochs of 64 images with ``remat``, a cosine ``lr_schedule``,
    ``grad_clip`` 1.0, the profiler on epoch 2 and checkpoints every epoch
    (``state_00N``, ``epoch_00N.pt``, the loss plot, a trace naming both growth
    kernels), then a 1-epoch run resumed from ``state_001``: step 4 to 8, its
    learning rates the schedule's at counts 4-7, launches counted around each
    run;
31. NCCL at world 1: ``torchrun --nproc_per_node 1`` on phase 10's CLI run
    with ``train.mesh {"data": -1}``, then twice without it, in one process:
    growth launches as phase 10's, the checkpoints' restored images against
    the plain run's within max(2e-3, twice the plain runs' own distance), the
    sharded step's ms beside the plain step's (the cost of sync-BN's and the
    gradient's all-reduces at world 1);
32. two ranks on the one card over ``gloo``: the full-width fp32 fused train
    step at B=16·256×384 on ``{"data": 2}`` and on ``{"spatial": 2}``
    against the one-process step (same weights, batch and masks; cuDNN
    deterministic), fused and canonical, each gradient leaf's relative L2
    distance within twice its own plain-vs-plain distance (its exact
    repeat, and the batch reordered six ways);
    16/16 growth launches a rank; the halo'd growth layer's kernels (#4-#7)
    against its plain version on H shards;
33. the expert-parallel server: ``run_pipeline --expert-mesh 3`` under
    ``torchrun --nproc_per_node 3`` (ranks over ``gloo``) on phase 24's 64
    PNGs and nine experts, top1 and sequential ``severity``, against phase
    24's one-process CLI (1 LSB), ``--expert-mesh 2`` refused; then a 2-rank
    ``RoutedRestorer`` on three experts (n_pad 1) against the unsharded one.
    Phases 31-33 run their ranks as ``chip_smoke.py --worker <name>
    <dir> [args]`` under torchrun, and print each run's backend, world
    size and mesh; their times are of ranks sharing one card, not scaling;
34. the native host-IO engine (``data.io_native``, built with g++): where it
    builds, 64 procedural PNGs and JPEGs (at, above and below 256x384)
    decoded bit for bit as its NumPy plain version, at size PNG equal to
    PIL and JPEG within 1 LSB, PNG encode round-trips, decode and encode
    img/s beside PIL's (4 threads), and phases 24's and 28's CLIs decoded
    through it (engine calls counted around them); where ``jpeglib.h`` or
    ``png.h`` is missing, the build's first error line and no engine check
    (every caller on PIL, as in the JAX package);
35. the bf16-activation DenseBlock (``db_bf16_act`` at
    ``db_k_stack_max_ci`` 56): kernels vs plain at the four B=128·256²
    block shapes, at bf16 x measurably nearer than the f32-activation
    kernels, each timed beside the f32-activation kernel; a tuning
    file under ``build/`` through ``MDIE_SERVING_TUNING``: the serving
    forward vs the f32 ``CDAN``, serving steps with the counts reset (17
    bf16-activation launches of 24 a step), the step timed beside the
    f32-activation one, and ``-p test`` through it;
36. LPIPS on VGG16 and SqueezeNet, card vs CPU at B=4·256x384 (f32, TF32
    off), and ``-p test`` with ``lpips: {net: vgg}``: its eval step's ms
    beside alex's;
37. ``train.scan_chunk: 4`` on phase 31's run in-process: the checkpoint
    against phase 31's plain runs (bit for bit, else within phase 31's
    limit), growth launches, an epoch's ms a step beside the plain loop's;
38. the port's tuner (``benchmarks/tune_serving``, ``--dry-run --iters 5``)
    at B=128·256² in-process, the serving counts reset around it: every
    variant (f32 and bf16 activations) sane, each one's ms in turns, the
    winner; the port's tuning file names this card and a variant found sane;
    the served default's forward vs the f32 ``CDAN`` and its ``-p test``
    beside phase 16's;
39. the bench (``python -m …_torch.bench``, ``BENCH_BUDGET_S=240``) as a
    subprocess: one JSON line naming this card and the tuning file's keys,
    its img/s beside phases 7 and 17;
40. ``benchmarks/train_throughput`` rows b16 and b16_fused (``--iters 2
    --chunk 4``) in-process, the growth counts reset around it: finite
    losses, the fused row's growth launches, ms a step beside phase 11's;
41. the fused bilinear x2 upsample + add (``ops.cuda.upsample``) vs its
    plain version at the decoder's three shapes of B=128·256² in bf16 (at
    most one bf16 step apart), f32 and ragged shapes, the scalar path
    bit-equal to the vector path on misaligned copies; 3 launches a
    forward of both built forwards and no aten ``upsample_bilinear2d``
    kernel in a profiled CM forward; each call's ms (CUDA events) beside
    its bytes bound, the plain version and aten's ``F.interpolate`` + add;
42. the fused CBAM with the decoder's product (``ops.cuda.cbam``) vs its
    plain version at the served forward's four CBAMs of B=128·256² and of 4
    rows of 256x384, bf16 (at most one bf16 step apart) and f32, with and
    without d; odd shapes and misaligned copies (the scalar path, bit-equal
    to the 16-byte path); a CUDA graph's replay bit-equal to the eager
    call; 4 calls a CM forward and no aten CBAM or product op in its trace;
    each call's ms (CUDA events) beside its byte bounds, the plain version
    and the eager chain + product it replaced;
43. the depthwise 3x3 kernel (``ops.cuda.dwconv``), plain and gated, vs its
    plain versions at the served Restormer's ten call shapes of
    B=4·480x640 in bf16 (at most one bf16 step apart) and at two odd shapes
    with a bias, bf16 and f32; a misaligned copy through the scalar path
    bit-equal to the 16-byte path; 88 launches (44 gated) a served forward
    and no aten depthwise or GELU kernel in its trace; each call's ms (CUDA
    events) beside its bytes bound, the plain version and bf16
    ``F.conv2d(groups=C)`` (+ ``F.gelu(a) * g``), and the 88 calls of a
    forward summed.

Phases 1-37 run the served forward with f32 activations, whatever the port's
tuning file chose on the card (``pin_forward``: a tuning file under
``build/``, ``PINNED_TUNING``); phases 38-40 run the port's own tuning.

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
import re
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
REMAT_STEPS = 10  # timed steps of each side in phase 29
REMAT_REPEATS = 5  # repeats of phase 29's plain step: its floor is their widest distance
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
        LAUNCHES_PER_BLOCK,
    )

    step, bench_clean = serving.build_pipeline(BENCH_BATCH, BENCH_SIZE, torch.bfloat16, "cuda")
    eval_clean = serving.clean_batch(EVAL_BATCH, *EVAL_HW, device="cuda")
    gen = torch.Generator().manual_seed(1)
    step(bench_clean, gen)  # warm-up (cuDNN algorithm choice)
    step(eval_clean, gen)
    torch.cuda.synchronize()

    _serving_counts(reset=True)
    outs = [step(bench_clean, gen) for _ in range(BENCH_STEPS)]
    outs += [step(eval_clean, gen) for _ in range(EVAL_STEPS)]
    torch.cuda.synchronize()
    launches = _serving_counts()

    n_steps = BENCH_STEPS + EVAL_STEPS
    for i, out in enumerate(outs):
        bsz, hw = (BENCH_BATCH, (BENCH_SIZE, BENCH_SIZE)) if i < BENCH_STEPS else (EVAL_BATCH, EVAL_HW)
        require(tuple(out.shape) == (bsz, *hw, 3) and out.dtype == torch.float32, "output shape")
        require(bool(torch.isfinite(out).all()), "outputs finite")
        require(out.min().item() >= 0.0 and out.max().item() <= 1.0, "outputs in [0, 1]")
    want = {"noise_degrade": n_steps, "dense_block": 4 * LAUNCHES_PER_BLOCK * n_steps,
            "conv3x3_pool": n_steps, "conv3x3": 7 * n_steps, "bilinear_x2_add": 3 * n_steps,
            "cbam_cm": 4 * n_steps}
    say("requests", f"{BENCH_STEPS} steps B={BENCH_BATCH}x{BENCH_SIZE}^2 + {EVAL_STEPS} steps "
        f"B={EVAL_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} bf16: finite, in [0,1]; launches {launches} "
        f"(expected {want})")
    require({k: launches[k] for k in want} == want,
            "per step one noise launch, 4 DenseBlocks x (entry + 4 growth + transition), "
            "one #9, seven #8, three upsample and four CBAM calls")
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
    """The bf16 CM forward vs the f32 ``CDAN`` at 2x256² and 2x256x384, every
    conv after conv1 on #8 (7 launches a forward): max <= 2e-2, mean <= 2e-3
    (tests/test_cdan_fast.py:108-109)."""
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import conv3x3, conv3x3_pool

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    model = model.to(dev)
    for hw in ((BENCH_SIZE, BENCH_SIZE), EVAL_HW):
        x = torch.rand((2, *hw, 3), device=dev, generator=g)
        with torch.inference_mode():
            ref = model(x)
        n0 = (conv3x3.launches, conv3x3_pool.launches)
        got = cdan_fast.build_fast_apply_cm(model, torch.bfloat16, dev)(x)
        torch.cuda.synchronize()
        n = (conv3x3.launches - n0[0], conv3x3_pool.launches - n0[1])
        err = (got - ref).abs()
        say("cm_forward", f"2x{hw[0]}x{hw[1]}: max {err.max().item():.3e} (limit 2e-2) mean "
            f"{err.mean().item():.3e} (limit 2e-3); launches conv3x3 {n[0]} conv3x3_pool {n[1]}")
        require(got.shape == ref.shape and bool(torch.isfinite(got).all()), "CM forward shape")
        require(err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, "CM forward vs module")
        require(n == (7, 1), "conv launches of one CM forward")


def phase_tiled_shapes(torch, model):
    """The DenseBlock kernel at the shapes where the JAX package takes the
    row-tiled ``_run_cm`` (#3), vs its plain version in f32 (the DenseBlock
    limits: max <= 5e-2, mean <= 5e-3); ``fused_dense_block_cm`` once; the
    whole per-block forward at 2x480x640 vs the f32 ``CDAN`` (2e-2, 2e-3)."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_fast_apply
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
        got = build_fast_apply(model, torch.bfloat16, dev)(x)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    say("tiled_shapes", f"per-block forward bf16 vs f32 CDAN at 2x{PHOTO_HW[0]}x{PHOTO_HW[1]}: "
        f"max {err.max().item():.3e} (limit 2e-2) mean {err.mean().item():.3e} (limit 2e-3)")
    require(err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, "per-block forward 480x640")
    return worst


def phase_requests_cm(torch):
    """Serving steps at B=128·256² (the served CM forward): one conv+pool,
    7 #8, 24 DenseBlock launches and 4 fused CBAM calls a step.  Returns the
    launches and the step."""
    from multi_degradation_image_enhancement_tpu_torch import serving
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK,
    )

    step, clean = serving.build_pipeline(BENCH_BATCH, BENCH_SIZE, torch.bfloat16, "cuda")
    gen = torch.Generator().manual_seed(3)
    step(clean, gen)  # warm-up
    torch.cuda.synchronize()
    _serving_counts(reset=True)
    outs = [step(clean, gen) for _ in range(BENCH_STEPS)]
    torch.cuda.synchronize()
    n = _serving_counts()
    for out in outs:
        require(tuple(out.shape) == (BENCH_BATCH, BENCH_SIZE, BENCH_SIZE, 3), "output shape")
        require(bool(torch.isfinite(out).all()) and out.min().item() >= 0.0
                and out.max().item() <= 1.0, "outputs finite, in [0, 1]")
    want = {"noise_degrade": BENCH_STEPS, "dense_block": 4 * LAUNCHES_PER_BLOCK * BENCH_STEPS,
            "conv3x3_pool": BENCH_STEPS, "conv3x3": 7 * BENCH_STEPS, "cbam_cm": 4 * BENCH_STEPS}
    say("requests_cm", f"{BENCH_STEPS} steps B={BENCH_BATCH}x{BENCH_SIZE}^2: finite, in [0,1]; "
        f"launches {n} (expected {want})")
    require({k: n[k] for k in want} == want, "CM step launches")
    return n, step, clean


def _cli_test(torch, name: str, ckpt_dir: Path, env=None, hw=None, images=TEST_IMAGES,
              task: str = "noise_synthetic", lpips_net=None):
    """One ``run.main`` ``-p test`` on ``<task>.json``'s test block cut to
    ``images`` images (optionally resized to ``hw``; the LPIPS metric on
    ``lpips_net`` when given), scoring the checkpoint in ``ckpt_dir``, every
    launch counted; with post-processing on, the ``post`` row and the
    post-processed PNGs too.  Returns its record."""
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
    if lpips_net is not None:
        for item in cfg["metrics"]["items"]:
            if item["name"] == "lpips":
                item["args"] = {"net": lpips_net}
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
        dense_block.bf16_act_launches = 0
        t0 = time.perf_counter()
        engine = run.main(config)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"dense_block": dense_block.launches, "conv3x3_pool": conv3x3_pool.launches,
                    "conv3x3": conv3x3.launches,
                    "dense_block_bf16_act": dense_block.bf16_act_launches}
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
    """``-p test`` through ``run.main`` on the pinned tuning: at 256x384 (one
    #9 and seven #8 launches a batch) and at 480x640 (the JAX package's #3
    route)."""
    ckpt_dir = Path(train_engine.model_path)
    shipped = _cli_test(torch, "shipped", ckpt_dir)
    require(shipped["launches"]["conv3x3_pool"] == shipped["batches"]
            and shipped["launches"]["conv3x3"] == 7 * shipped["batches"],
            "one conv+pool and seven #8 launches per batch")
    photo = _cli_test(torch, "photo_480x640", ckpt_dir, hw=PHOTO_HW, images=PHOTO_IMAGES)
    return shipped, photo


def eval_times(torch, smi, model, shipped, step, clean):
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
    times["cm_step_ms"] = a = cuda_ms(lambda: step(clean, gen), 10)
    say("times", f"[{smi}] degrade->restore B={BENCH_BATCH}x{BENCH_SIZE}^2 (phase 15's step): "
        f"{a:.3f} ms/step ({BENCH_BATCH / a * 1e3:.1f} img/s)")

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
    warm-up: device time a step, busy share, and the served forward's device
    time split by the program's spans (``utils.tracing``): the bilinear
    upsamples, the CBAMs and the rest of the forward (DenseBlocks, convs,
    pools, elementwise)."""
    from torch.profiler import ProfilerActivity, profile

    from multi_degradation_image_enhancement_tpu_torch.utils import tracing

    gen = torch.Generator().manual_seed(6)
    step(clean, gen)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(clean, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    spans = {name: ms / steps for name, (_, ms) in tracing.device_totals().items()}
    tracing.reset()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    total = sum(device_us(e) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")) / 1e3 / steps
    forward = spans.get("serve/forward", 0.0)
    require(total > 0 and forward > 0, "the profiler saw device time and the spans the forward")
    shares = {"upsample": spans.get("cdan/upsample", 0.0), "cbam": spans.get("cdan/cbam", 0.0)}
    shares["rest of the forward"] = forward - sum(shares.values())
    say("profile", f"[{smi}] serving step B={BENCH_BATCH}x{BENCH_SIZE}^2 bf16 under torch.profiler "
        f"({steps} steps): {total:.3f} ms of kernels a step, {wall_ms:.3f} ms wall, busy share "
        f"{total / wall_ms:.3f}; the forward's device range {forward:.3f} ms: "
        + ", ".join(f"{k} {v:.3f} ms ({v / forward:.1%})" for k, v in shares.items()))
    return shares


# (layer, (batch, c, H, W)) of the decoder's three bilinear x2 inputs at
# B=128·256²; each output (and the skip or residual added to it) is 2H x 2W.
UPSAMPLES = [("de2", (BENCH_BATCH, 128, 32, 32)), ("de3", (BENCH_BATCH, 64, 64, 64)),
             ("de4", (BENCH_BATCH, 3, 128, 128))]


def bf16_ulp_gap(torch, a, b):
    """Elementwise distance of two bf16 tensors in bf16 steps."""
    def ordered(t):
        v = t.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return (ordered(a) - ordered(b)).abs()


def upsample_work(shapes, io_bytes=2):
    """FLOPs and bytes of ``bilinear_x2_add`` calls: x read once, r read
    once, y written once; about 6 FLOPs an output (the row and column blends
    a thread shares between its outputs, and the add)."""
    outputs = sum(b * c * 4 * h * w for b, c, h, w in shapes)
    inputs = sum(b * c * h * w for b, c, h, w in shapes)
    return 6 * outputs, (inputs + 2 * outputs) * io_bytes


def phase_upsample(torch, smi):
    """Phase 41: the fused bilinear x2 upsample + add against its plain version;
    its launch count reset at the start and the phase's total reported (the
    served forward's own count is phase 38's)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.upsample import (
        bilinear_x2_add,
        bilinear_x2_add_plain,
        vector_path,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    bilinear_x2_add.launches = 0

    def inputs(shape, dtype):
        b, c, h, w = shape
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        return x, torch.randn((b, c, 2 * h, 2 * w), device=dev, generator=gen).to(dtype)

    def misaligned(t):  # the same values 2 bytes past a 16-byte boundary
        flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        view = flat[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    gaps, times, worst = {}, {}, 0
    for name, shape in UPSAMPLES:
        x, r = inputs(shape, torch.bfloat16)
        y = bilinear_x2_add(x, r)
        require(vector_path(x, r, y), f"{name}: the vector path")
        gap = bf16_ulp_gap(torch, y, bilinear_x2_add_plain(x, r))
        torch.cuda.synchronize()
        gaps[name] = int(gap.max().item())
        worst = max(worst, gaps[name])
        exact = (gap == 0).float().mean().item()
        require(gaps[name] <= 1, f"{name}: kernel within one bf16 step of plain, got {gaps[name]}")
        ms = cuda_ms(lambda: bilinear_x2_add(x, r), 20)
        plain_ms = cuda_ms(lambda: bilinear_x2_add_plain(x, r), 5)
        lib_ms = cuda_ms(lambda: F.interpolate(x, scale_factor=2, mode="bilinear",
                                               align_corners=False) + r, 5)
        bound_ms, _ = bound(*upsample_work([shape]), "f32")
        times[name] = (ms, plain_ms, lib_ms)
        say("upsample", f"[{smi}] {name} x{list(shape)} bf16: max gap {gaps[name]} bf16 step(s) "
            f"({exact:.4%} equal); kernel {ms:.4f} ms, bound {bound_ms:.4f} ms (bytes; "
            f"{bound_ms / ms:.1%}), plain {plain_ms:.3f} ms, aten F.interpolate + add "
            f"{lib_ms:.3f} ms")
    x, r = inputs(UPSAMPLES[0][1], torch.bfloat16)
    x, r = x[:8], r[:8]
    xs, rs = misaligned(x), misaligned(r)
    require(not vector_path(xs, rs, rs), "misaligned copies take the scalar path")
    require(torch.equal(bilinear_x2_add(xs, rs), bilinear_x2_add(x, r)),
            "the scalar path bit-equal to the vector path")
    for shape in ((2, 3, 5, 7), (2, 16, 6, 10), (3, 2, 1, 1), (2, 64, 33, 47), (2, 8, 16, 16)):
        for dtype in (torch.bfloat16, torch.float32):
            x, r = inputs(shape, dtype)
            got, want = bilinear_x2_add(x, r), bilinear_x2_add_plain(x, r)
            if dtype == torch.bfloat16:
                g = int(bf16_ulp_gap(torch, got, want).max().item())
                require(g <= 1, f"{shape} bf16: within one step of plain, got {g}")
            else:
                err = (got - want).abs().max().item()  # N(0, 1) inputs: a few f32 steps
                require(err <= 1e-5, f"{shape} f32: gap {err:.2e} (limit 1e-5)")
    say("upsample", "ragged shapes (odd H and W, W not a multiple of 4, 1x1) and f32 vs plain: ok")

    model = live_cdan(torch, 41).to(dev)
    xi = torch.rand((2, BENCH_SIZE, BENCH_SIZE, 3), device=dev, generator=gen)
    for builder in ("build_fast_apply", "build_fast_apply_cm"):
        fwd = getattr(cdan_fast, builder)(model, torch.bfloat16, dev)
        fwd(xi)
        n0 = bilinear_x2_add.launches
        fwd(xi)
        torch.cuda.synchronize()
        per_forward = bilinear_x2_add.launches - n0
        require(per_forward == 3, f"{builder}: 3 launches a forward, got {per_forward}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd(xi)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    aten = [k for k in names if "upsample_bilinear2d" in k]
    fused = [k for k in names if "upsample_add" in k]
    require(not aten and fused, f"the CM forward's kernels: no aten upsample ({aten}), the fused "
            f"kernel ({fused})")
    total = sum(t[0] for t in times.values())
    bound_all, _ = bound(*upsample_work([s for _, s in UPSAMPLES]), "f32")
    say("upsample", f"[{smi}] 3 launches a forward (both forwards); the CM forward's device ops "
        f"name {fused} and no upsample_bilinear2d; the three calls of a B={BENCH_BATCH} batch "
        f"{total:.4f} ms against their bound {bound_all:.4f} ms ({bound_all / total:.1%}; target "
        f"<= 0.45 ms), aten F.interpolate + add {sum(t[2] for t in times.values()):.3f} ms")
    return {"launches": bilinear_x2_add.launches, "max_ulp_gap": worst, "ms": total,
            "plain_ms": sum(t[1] for t in times.values()),
            "library_ms": sum(t[2] for t in times.values())}


# (layer, (batch, c, H, W), the decoder's product after it) of the served
# forward's four CBAMs at B=128·256², and at 4 rows of 256x384 (an expert of
# the routed pipeline).
CBAMS = [("bottleneck", (BENCH_BATCH, 512, 32, 32), False),
         ("cbam1", (BENCH_BATCH, 256, 32, 32), True),
         ("cbam2", (BENCH_BATCH, 128, 64, 64), True),
         ("cbam3", (BENCH_BATCH, 64, 128, 128), True)]
CBAMS_ROUTED = [(name, (4, c, h, w * 3 // 2), with_d) for name, (_, c, h, w), with_d in CBAMS]
# names a CM forward's device ops may not hold once CBAM and its product are
# fused: aten's pools over H×W and C, the broadcast products, cuDNN's 7×7 conv
# and the compress map's cat
EAGER_CBAM_OPS = ("reduce_kernel", "MulFunctor", "convolve", "cudnn", "CatArrayBatchedCopy")
CBAM_KERNELS = ("cbam_pool_kernel", "cbam_gate_kernel", "cbam_compress_kernel", "cbam_apply_kernel")


def cbam_kernel(key: str):
    """The fused CBAM's kernel a profiler key names, or None."""
    m = re.search(r"cbam_[a-z]+_kernel", key)
    return m.group(0) if m and m.group(0) in CBAM_KERNELS else None


def cbam_work(shapes, io_bytes=2):
    """FLOPs and bytes of ``cbam_cm`` calls, ``shapes`` (batch, c, H, W, with
    d): about 12 FLOPs an element (sum and max, the gated max and sum, the
    products) and 2 * 98 + 2 a pixel (the 7x7 conv, the sigmoid).  Bytes
    two ways: each byte once (x and d read, y written: the roofline's
    count), and the design's (x read by each of its three passes)."""
    flops = once = design = 0
    for b, c, h, w, with_d in shapes:
        n = b * c * h * w
        flops += 12 * n + 198 * b * h * w
        once += (2 + with_d) * n * io_bytes
        design += (4 + with_d) * n * io_bytes
    return flops, once, design


def eager_cbam(torch, x, pack, d=None):
    """The served forward's CBAM before the fused kernel: the eager chain on
    weights in x's dtype, rounding after each op, then the product by d."""
    import torch.nn.functional as F

    p = {k: v.to(x.dtype) for k, v in pack.items()}

    def mlp(v):
        return F.linear(torch.relu(F.linear(v, p["w1"], p["b1"])), p["w2"], p["b2"])

    x = x * torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))[:, :, None, None]
    comp = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
    y = x * torch.sigmoid(F.conv2d(comp, p["k7"], p["bsp"], padding=3))
    return y if d is None else y * d


def phase_cbam(torch, smi):
    """Phase 42: the fused CBAM with the decoder's product (``ops.cuda.cbam``)
    against its plain version at the served forward's four CBAMs of
    B=128·256² and of 4 rows of 256x384, in bf16 (within one bf16 step) and
    f32, with and without d; odd shapes and misaligned copies through the
    scalar path, bit-equal to the 16-byte path; two calls bit-equal, and a
    CUDA graph's replay bit-equal to the eager call; 4 calls a served CM
    forward and none of aten's CBAM ops in its trace; each B=128 call's ms
    (CUDA events) beside its byte bounds, the plain version and the eager
    chain it replaced."""
    from torch.profiler import ProfilerActivity, profile

    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
    from multi_degradation_image_enhancement_tpu_torch.models.cbam import CBAM
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.cbam import (
        cbam_cm,
        cbam_cm_plain,
        cbam_plan,
        vector_path,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(42)
    cbam_cm.launches = 0
    torch.manual_seed(42)
    packs = {}
    for name, (_, c, _, _), _ in CBAMS:
        mod = CBAM(c).eval()
        bn = mod.SpatialGate.spatial.bn
        with torch.no_grad():
            bn.running_mean.uniform_(-0.3, 0.3)
            bn.running_var.uniform_(0.2, 0.8)
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
        packs[name] = cdan_fast.pack_cbam_cm(mod, dev)

    def inputs(shape, dtype):
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        return x, (torch.rand(shape, device=dev, generator=gen) * 2).to(dtype)

    def misaligned(t):  # the same values 2 bytes past a 16-byte boundary
        flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        view = flat[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    def compare(label, got, want):
        if got.dtype == torch.bfloat16:
            gap = int(bf16_ulp_gap(torch, got, want).max().item())
            require(gap <= 1, f"{label}: kernel within one bf16 step of plain, got {gap}")
            return gap
        err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
        require(err <= 1e-5, f"{label}: f32 gap {err:.2e} of the largest value (limit 1e-5)")
        return 0

    worst = 0
    for rows, table in (("B=128x256^2", CBAMS), ("4 rows of 256x384", CBAMS_ROUTED)):
        for name, shape, _ in table:
            for dtype in (torch.bfloat16, torch.float32):
                x, d = inputs(shape, dtype)
                for dd in (None, d):
                    y = cbam_cm(x, packs[name], dd)
                    require(vector_path(x, y, dd), f"{name} {rows}: the 16-byte path")
                    worst = max(worst, compare(f"{name} {rows} {dtype} d={dd is not None}", y,
                                               cbam_cm_plain(x, packs[name], dd)))
                del x, d, y
        say("cbam", f"{rows}: the four CBAMs in bf16 and f32, with and without d, vs plain: ok "
            f"(plans {[tuple(cbam_plan(*s)) for _, s, _ in table]})")
    for shape in ((2, 16, 5, 7), (1, 32, 1, 1), (3, 64, 33, 47), (2, 128, 6, 10)):
        pack = cdan_fast.pack_cbam_cm(CBAM(shape[1]).eval(), dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, d = inputs(shape, dtype)
            worst = max(worst, compare(f"{shape} {dtype}", cbam_cm(x, pack, d),
                                       cbam_cm_plain(x, pack, d)))
    x, d = inputs((8, 128, 64, 64), torch.bfloat16)
    xs, ds = misaligned(x), misaligned(d)
    ys = cbam_cm(xs, packs["cbam2"], ds)
    require(not vector_path(xs, ys, ds), "misaligned copies take the scalar path")
    y = cbam_cm(x, packs["cbam2"], d)
    require(torch.equal(ys, y), "the scalar path bit-equal to the 16-byte path")
    require(torch.equal(cbam_cm(x, packs["cbam2"], d), y), "two calls bit-equal")
    say("cbam", "odd shapes (5x7, 1x1, 33x47, W % 8 != 0) and f32 vs plain; misaligned copies "
        "through the scalar path bit-equal; two calls bit-equal: ok")

    static_x, static_d = x.clone(), d.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cbam_cm(static_x, packs["cbam2"], static_d)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_y = cbam_cm(static_x, packs["cbam2"], static_d)
    x2, d2 = inputs(tuple(x.shape), torch.bfloat16)
    static_x.copy_(x2)
    static_d.copy_(d2)
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(static_y, cbam_cm(x2, packs["cbam2"], d2)),
            "the CUDA graph's replay bit-equal to the eager call")
    say("cbam", "captured in a CUDA graph; the replay on new inputs bit-equal to the eager call")
    del x, d, xs, ds, y, ys, static_x, static_d, static_y, x2, d2, graph

    model = live_cdan(torch, 42).to(dev)
    xi = torch.rand((2, BENCH_SIZE, BENCH_SIZE, 3), device=dev, generator=gen)
    fwd = cdan_fast.build_fast_apply_cm(model, torch.bfloat16, dev)
    fwd(xi)
    n0 = cbam_cm.launches
    fwd(xi)
    torch.cuda.synchronize()
    per_forward = cbam_cm.launches - n0
    require(per_forward == 4, f"the CM forward: 4 cbam_cm calls, got {per_forward}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd(xi)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    ours = {cbam_kernel(k) for k in names} - {None}
    eager = [k for k in names if any(op in k for op in EAGER_CBAM_OPS)]
    require(ours == set(CBAM_KERNELS) and not eager, f"the CM forward's kernels: the four CBAM "
            f"launches ({ours}), no eager CBAM or product op ({eager})")
    say("cbam", f"4 calls a CM forward; its device ops name the CBAM kernels {sorted(ours)} and "
        f"none of {EAGER_CBAM_OPS}: {sorted(k[:60] for k in names)}")

    times = {}
    for name, shape, with_d in CBAMS:
        x, d = inputs(shape, torch.bfloat16)
        d = d if with_d else None
        pack = packs[name]
        ms = cuda_ms(lambda: cbam_cm(x, pack, d), 20)
        plain_ms = cuda_ms(lambda: cbam_cm_plain(x, pack, d), 3)
        lib_ms = cuda_ms(lambda: eager_cbam(torch, x, pack, d), 10)
        once_ms, design_ms = (v / HBM_BYTES_PER_S * 1e3 for v in cbam_work([(*shape, with_d)])[1:])
        times[name] = (ms, plain_ms, lib_ms)
        say("cbam", f"[{smi}] {name} x{list(shape)} bf16{' * d' if with_d else ''}: kernel "
            f"{ms:.4f} ms, bounds {once_ms:.4f} ms (each byte once; {once_ms / ms:.1%}) / "
            f"{design_ms:.4f} ms (x read three times; {design_ms / ms:.1%}), plain "
            f"{plain_ms:.3f} ms, eager chain {lib_ms:.3f} ms; plan {tuple(cbam_plan(*shape))}")
        del x, d
    total = sum(t[0] for t in times.values())
    once_ms, design_ms = (v / HBM_BYTES_PER_S * 1e3
                          for v in cbam_work([(*s, wd) for _, s, wd in CBAMS])[1:])
    say("cbam", f"[{smi}] the four calls of a B={BENCH_BATCH} batch {total:.4f} ms against "
        f"{once_ms:.4f} ms (each byte once) and {design_ms:.4f} ms (x thrice; "
        f"{design_ms / total:.1%}), eager chain + product "
        f"{sum(t[2] for t in times.values()):.3f} ms")
    return {"launches": cbam_cm.launches, "max_ulp_gap": worst, "ms": total,
            "plain_ms": sum(t[1] for t in times.values()),
            "library_ms": sum(t[2] for t in times.values())}


# (output channels, H, W, gated, calls a forward) of the served Restormer's
# depthwise 3x3 convs at B=4·480x640: MDTA's over 3C channels, GDFN's 2h -> h
DWCONVS = [(144, 480, 640, False, 4), (288, 480, 640, False, 8), (288, 240, 320, False, 12),
           (576, 120, 160, False, 12), (1152, 60, 80, False, 8),
           (127, 480, 640, True, 4), (255, 480, 640, True, 8), (255, 240, 320, True, 12),
           (510, 120, 160, True, 12), (1021, 60, 80, True, 8)]
DWCONV_BATCH, DWCONV_HW = 4, (480, 640)
# two shapes off the served ones: W % 8 != 0 (the scalar path), and a narrow plane
DWCONV_ODD = [(2, 6, 33, 47), (3, 10, 5, 16)]


def dwconv_work(calls, batch=DWCONV_BATCH, io_bytes=2):
    """FLOPs (a multiply-add of each of the 9 taps of every input element, in
    f32) and bytes (x read once, y written once, the weights) of depthwise
    calls ``(c_out, H, W, gated, count)``."""
    flops = nbytes = 0
    for c, h, w, gated, n in calls:
        c_in = 2 * c if gated else c
        flops += n * 18 * batch * c_in * h * w
        nbytes += n * ((c_in + c) * batch * h * w + 9 * c_in) * io_bytes
    return flops, nbytes


def phase_dwconv(torch, smi):
    """Phase 43: the depthwise 3x3 kernel (``ops.cuda.dwconv``) against its
    plain versions, both epilogues, at the served Restormer's ten call
    shapes of B=4·480x640 in bf16 (at most one bf16 step apart) and at two
    odd shapes with a bias in bf16 and f32; misaligned copies through the
    scalar path bit-equal to the 16-byte path; 88 launches (44 gated) a
    served forward, with no aten depthwise, GELU or gate-product kernel in
    its trace; each call's ms (CUDA events) beside its bytes bound, the
    plain version and the library yardstick (bf16 ``F.conv2d(groups=C)``,
    then ``F.gelu(a) * g`` for the gate)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from multi_degradation_image_enhancement_tpu_torch.models.restormer import (
        Restormer,
        serving_forward,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda import dwconv
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dwconv import (
        depthwise3x3,
        depthwise3x3_gated,
        depthwise3x3_gated_plain,
        depthwise3x3_plain,
        dwconv_plan,
        vector_path,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(43)

    def inputs(shape, gated, dtype=torch.bfloat16, bias=False):
        c_in = shape[1] * (2 if gated else 1)
        x = torch.randn((shape[0], c_in, *shape[2:]), device=dev, generator=gen).to(dtype)
        w = (torch.randn((c_in, 1, 3, 3), device=dev, generator=gen) / 3).to(dtype)
        b = torch.randn((c_in,), device=dev, generator=gen).to(dtype) if bias else None
        return x, w, b

    def entry(gated):
        return (depthwise3x3_gated, depthwise3x3_gated_plain) if gated else (
            depthwise3x3, depthwise3x3_plain)

    def library(x, w, gated):
        y = F.conv2d(x, w, None, padding=1, groups=x.shape[1])
        if not gated:
            return y
        a, g = y.chunk(2, dim=1)
        return F.gelu(a) * g

    def compare(label, got, want):
        if got.dtype == torch.bfloat16:
            gap = int(bf16_ulp_gap(torch, got, want).max().item())
            require(gap <= 1, f"{label}: kernel within one bf16 step of plain, got {gap}")
            return gap
        err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
        require(err <= 1e-5, f"{label}: f32 gap {err:.2e} of the largest value (limit 1e-5)")
        return 0

    worst = 0
    for c, h, w, gated, _ in DWCONVS:
        x, wt, _ = inputs((DWCONV_BATCH, c, h, w), gated)
        kernel, plain = entry(gated)
        y = kernel(x, wt)
        require(vector_path(x, y), f"{c}x{h}x{w}: the 16-byte path")
        worst = max(worst, compare(f"{c}x{h}x{w} gated={gated}", y, plain(x, wt)))
        del x, wt, y
    for shape in DWCONV_ODD:
        for dtype in (torch.bfloat16, torch.float32):
            for gated in (False, True):
                x, wt, b = inputs(shape, gated, dtype, bias=True)
                kernel, plain = entry(gated)
                worst = max(worst, compare(f"{shape} {dtype} gated={gated}", kernel(x, wt, b),
                                           plain(x, wt, b)))
    x, wt, _ = inputs((2, 64, 48, 64), True)
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=dev)
    xs = flat[1:1 + x.numel()].view(x.shape)  # the same values 2 bytes past a 16-byte boundary
    xs.copy_(x)
    y = depthwise3x3_gated(x, wt)
    ys = depthwise3x3_gated(xs, wt)
    require(not vector_path(xs, ys), "a misaligned copy takes the scalar path")
    require(torch.equal(ys, y), "the scalar path bit-equal to the 16-byte path")
    require(torch.equal(depthwise3x3_gated(x, wt), y), "two calls bit-equal")
    say("dwconv", f"the ten served call shapes of B={DWCONV_BATCH}x{DWCONV_HW}, both "
        f"epilogues, vs plain: ok (worst {worst} bf16 step; plans "
        f"{[tuple(dwconv_plan(DWCONV_BATCH, c, h, w)) for c, h, w, _, _ in DWCONVS]}); odd "
        f"shapes {DWCONV_ODD} with a bias, bf16 and f32: ok; the scalar path bit-equal; two "
        f"calls bit-equal")
    del x, wt, xs, ys, y, flat

    fwd = serving_forward(Restormer().eval().to(dev), torch.bfloat16, dev)
    xi = torch.rand((DWCONV_BATCH, *DWCONV_HW, 3), device=dev, generator=gen)
    fwd(xi)
    torch.cuda.synchronize()
    dwconv.launches = dwconv.gated_launches = 0
    fwd(xi)
    torch.cuda.synchronize()
    per_forward = (dwconv.launches, dwconv.gated_launches)
    require(per_forward == (88, 44), f"a served forward: 88 dwconv launches, 44 gated; got "
            f"{per_forward}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd(xi)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    ours = sorted({k[:60] for k in names if "dw3x3_" in k})
    eager = [k[:60] for k in names if "depthwise" in k.lower() or "gelu" in k.lower()]
    require(ours and not eager, f"the served forward's kernels: ours {ours}, no aten depthwise "
            f"or GELU kernel ({eager})")
    say("dwconv", f"88 launches a served forward (44 gated); its trace names {ours} and no aten "
        f"depthwise or GELU kernel")
    del fwd, xi

    times = {}
    for c, h, w, gated, n in DWCONVS:
        x, wt, _ = inputs((DWCONV_BATCH, c, h, w), gated)
        kernel, plain = entry(gated)
        ms = cuda_ms(lambda: kernel(x, wt), 20)
        plain_ms = cuda_ms(lambda: plain(x, wt), 3)
        lib_ms = cuda_ms(lambda: library(x, wt, gated), 10)
        bound_ms = dwconv_work([(c, h, w, gated, 1)])[1] / HBM_BYTES_PER_S * 1e3
        times[(c, h, w, gated)] = (ms, plain_ms, lib_ms, n)
        say("dwconv", f"[{smi}] {'gated ' if gated else ''}{c}x{h}x{w} B={DWCONV_BATCH}: kernel "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_ms / ms:.1%}), plain {plain_ms:.3f} "
            f"ms, library {lib_ms:.4f} ms; plan {tuple(dwconv_plan(DWCONV_BATCH, c, h, w))}")
        del x, wt
    total = {k: sum(t[i] * t[3] for t in times.values()) for i, k in enumerate(("ms", "plain", "lib"))}
    bound_ms = dwconv_work(DWCONVS)[1] / HBM_BYTES_PER_S * 1e3
    say("dwconv", f"[{smi}] the 88 calls of a B={DWCONV_BATCH}x{DWCONV_HW} forward: kernel "
        f"{total['ms']:.3f} ms against {bound_ms:.3f} ms ({bound_ms / total['ms']:.1%}), library "
        f"{total['lib']:.3f} ms, plain {total['plain']:.3f} ms")
    return {"launches": per_forward[0], "max_ulp_gap": worst, "ms": total["ms"],
            "plain_ms": total["plain"], "library_ms": total["lib"]}


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
    the DenseBlock and expert-forward counts reset just before (DenseBlock
    launches, whole blocks of them: on the card the experts are the
    hand-kernel serving forward, whose eager warm-up and capture calls
    launch and whose graph replays do not count; and the forwards its own
    probabilities call for), and as a subprocess (``python
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
    from multi_degradation_image_enhancement_tpu_torch.data import io_native
    from multi_degradation_image_enhancement_tpu_torch.data.streaming import decode_chunk
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK, dense_block,
    )
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

    def load_counted(*args, **kwargs):
        names, forwards = load_expert_bank(*args, **kwargs)

        def counted(forward):
            def run(x):
                ran[0] += 1
                return forward(x)
            return run
        return names, [None if f is None else counted(f) for f in forwards]

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
            io_native.decode_calls = io_native.encode_calls = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                run_pipeline.main(argv(out_main))
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches, forwards = dense_block.launches, ran[0]
            io_calls = {"decode": io_native.decode_calls, "encode": io_native.encode_calls}
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
               f"{expected}) and {launches} dense_block launches (the serving forward's); "
               f"native host-IO calls {io_calls}")
        rec = {"launches": launches, "expert_forwards": forwards, "cli_s": cli_s, "io": io_calls}
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
        require(launches > 0 and launches % LAUNCHES_PER_BLOCK == 0,
                "whole DenseBlocks launched: the experts run the hand-kernel serving forward")

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
    images, through the route ``load_expert_bank`` builds on the card (the
    hand-kernel serving forward, bf16, as a CUDA graph) and through the eval
    module under a bf16 autocast (the JAX pipeline's route, the bank's
    before), each against the f32 module (TF32 off): max and mean |d| and
    the PSNR of the route's output against the f32 module's."""
    from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN, eval_forward
    from multi_degradation_image_enhancement_tpu_torch.pipeline import load_expert_bank

    path = str(art["weights"] / "CDAN_noise.pt")
    model = load_weights(path, CDAN()).to("cuda").eval()
    ref_fn = eval_forward(model, torch.float32)
    routes = {"bank": load_expert_bank({"noise": path}, torch.device("cuda"), torch.bfloat16)[1][0],
              "module": eval_forward(model, torch.bfloat16)}
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
    from multi_degradation_image_enhancement_tpu_torch.data import io_native
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

    dense_block.launches = io_native.decode_calls = io_native.encode_calls = 0
    t0 = time.perf_counter()
    tester = run.main(load_config(str(work / "config.json"), phase="test"))
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = dense_block.launches
    io_calls = {"decode": io_native.decode_calls, "encode": io_native.encode_calls}
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
        f"scores {scores}, dense_block launches {test_launches}, native host-IO calls "
        f"{io_calls}; eval step {eval_ms:.3f} ms per B={bsz} batch ({bsz / eval_ms * 1e3:.1f} "
        "img/s)")
    require(math.isfinite(loss) and engine.network.fused_dense, "finite loss, fused DenseBlocks")
    require(train_launches["growth_train_fwd"] == 16 * steps * (1 + passes)
            and train_launches["growth_train_bwd"] == 16 * steps, "growth-train launches (#4-#7)")
    require(train_launches["dense_block"] == 0, "training runs no inference DenseBlock")
    require(test_launches == 4 * LAUNCHES_PER_BLOCK * test_batches, "DenseBlock launches (#2)")
    require(pngs == n["test"] and all(math.isfinite(v) for v in scores.values()), "test outputs")
    return {"train_launches": train_launches, "test_launches": test_launches,
            "train_ms": step_ms, "eval_ms": eval_ms, "io": io_calls}


def _remat_step(torch, model, remat: bool, precision: str, batch, masks, record=None):
    """One ``make_train_step`` on a copy of ``model`` with ``remat``: (loss,
    grads, buffers, peak bytes, growth launches (fwd, bwd), state, step fn).
    With ``record``, the output dtype of a conv (``encoder.conv2``) and a
    linear (``bottleneck`` MLP) is appended to it at every call."""
    import copy

    from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
    from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline

    m = copy.deepcopy(model)
    m.fused_dense, m.remat = True, remat
    if record is not None:
        for name, layer in (("conv", m.encoder.conv2.conv), ("linear", m.bottleneck.ChannelGate.mlp[1])):
            layer.register_forward_hook(lambda mod, args, out, name=name: record.append((name, out.dtype)))
    state = TrainState.create(m, 1e-3)
    step = make_train_step(build_loss_pipeline(_loss_config(), "cuda"), precision)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    growth_layer_fwd.launches = growth_layer_bwd.launches = 0
    loss = step(state, *batch, masks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = (growth_layer_fwd.launches, growth_layer_bwd.launches)
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    buffers = {n: b.clone() for n, b in m.named_buffers()}
    return loss, grads, buffers, peak, launches, state, step


def _bn_fed_biases(model) -> set:
    """Names of the conv biases whose output a train-mode BatchNorm
    normalises (each ConvBlock's, each growth layer's, the decoder deconvs'):
    their exact gradient is 0, so what a step computes for them is rounding
    dust of a cancellation."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import ConvBlock, DenseBlock

    names = {f"decoder.conv{i}.bias" for i in range(1, 5)}
    for name, m in model.named_modules():
        if isinstance(m, ConvBlock):
            names.add(f"{name}.conv.bias")
        elif isinstance(m, DenseBlock):
            names.update(f"{name}.layers.{i}.2.bias" for i in range(m.num_layers))
    return names


def _grad_distance(got, want, dust):
    """(the worst leaf's relative L2 distance outside ``dust``, that leaf,
    the largest |got - want| over ``dust``), from ``_leaf_distance``."""
    leaves, dust_err = _leaf_distance(got, want, dust)
    rel, leaf = max((v, n) for n, v in leaves.items())
    return rel, leaf, dust_err


def phase_remat(torch, smi):
    """Phase 29: noise_synthetic's fused train step at B=16·256x384 without
    and with ``remat`` (the engine's init, the same batch and dropout masks),
    cuDNN deterministic, in bf16 (the recipe's precision) and in fp32, the
    plain step repeated ``REMAT_REPEATS`` times for the card's own repeat
    distance.

    Loss and every buffer (running statistics) bit-equal; 16 growth forwards
    and 16 backwards plain, 32 and 16 under remat; a conv and a linear inside
    remat blocks return bf16 at every call, the recomputation's included
    (the autocast is restored for it); the gradients no farther from the
    plain step's than twice the widest of its repeats' distances from it:
    the worst leaf's relative L2 distance (``_leaf_distance``, phase 32's
    measure) and, for the 24 conv biases feeding a BatchNorm
    (``_bn_fed_biases``: zero in exact arithmetic), the largest absolute
    difference.  The step is not reproducible on the card (the bilinear
    upsample's backward adds with atomics, and the growth kernels round to
    bf16 downstream of it): over seven repeats the worst leaf read 6.2e-3 to
    9.4e-3 in bf16 and 1.3e-4 to 2.6e-4 in fp32, and remat's runs the same.
    A leaf's largest element is no yardstick: one element of
    ``encoder.dense3.layers.1.2.weight`` flips between two roundings from
    run to run, so that reading is 1.6e-4 to 3.6e-4 or 7.0e-4 to 7.8e-4 in
    fp32, and a remat run that flips against repeats that do not exceeds
    twice them.  A fixed 1e-5 cannot be met by the plain step against
    itself; the CPU tests (tests/test_torch_remat.py) hold remat bit-equal
    where the step is deterministic.  Then the peak memory of each step (reset between them;
    remat must lower it) and its mean ms over ``REMAT_STEPS`` steps by CUDA
    events."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    from multi_degradation_image_enhancement_tpu_torch.models.torch_init import flax_default_init_

    dev = torch.device("cuda")
    model = flax_default_init_(CDAN(), torch.Generator().manual_seed(29)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.rand((TRAIN_BATCH, *EVAL_HW, 3), device=dev, generator=gen)
    t = torch.clamp(x + 0.1 * torch.randn(x.shape, device=dev, generator=gen), 0.0, 1.0)
    masks = [torch.rand((TRAIN_BATCH, c, EVAL_HW[0] // p, EVAL_HW[1] // p), device=dev,
                        generator=gen) < 0.8 for c, p in ((64, 2), (128, 4), (256, 8), (512, 8))]
    dust = _bn_fed_biases(model)
    require(dust <= {n for n, _ in model.named_parameters()} and len(dust) == 24,
            "the 24 BatchNorm-fed conv biases")
    dtypes = []
    names = ("plain", *(f"repeat{i}" for i in range(REMAT_REPEATS)), "remat")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {(prec, name): _remat_step(torch, model, name == "remat", prec, (x, t), masks,
                                          dtypes if (prec, name) == ("bf16", "remat") else None)
                for prec in ("bf16", "fp32") for name in names}
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def floor(prec):  # the widest distance of a repeat from the plain step, each part apart
        ds = [_grad_distance(runs[(prec, n)][1], runs[(prec, "plain")][1], dust)
              for n in names[1:-1]]
        return max(d[0] for d in ds), max(d[2] for d in ds)

    plain, remat = runs[("bf16", "plain")], runs[("bf16", "remat")]
    loss_equal = all(torch.equal(plain[0][k], remat[0][k]) for k in plain[0])
    bufs_differ = [n for n in plain[2] if not torch.equal(plain[2][n], remat[2][n])]
    b_rel, b_leaf, b_dust = _grad_distance(remat[1], plain[1], dust)
    b_floor, b_dust_floor = floor("bf16")
    f_plain, f_remat = runs[("fp32", "plain")], runs[("fp32", "remat")]
    f_rel, f_leaf, f_dust = _grad_distance(f_remat[1], f_plain[1], dust)
    f_floor, f_dust_floor = floor("fp32")
    calls = {k: [d for n, d in dtypes if n == k] for k in ("conv", "linear")}  # before timing
    ms = {}
    for name, (_, _, _, _, _, state, step) in (("plain", plain), ("remat", remat)):
        ms[name] = cuda_ms(lambda: step(state, x, t, masks), REMAT_STEPS, 2)
    say("remat", f"[{smi}] B={TRAIN_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} bf16 fused: loss "
        f"{float(plain[0]['total']):.6f} vs {float(remat[0]['total']):.6f} (bit-equal "
        f"{loss_equal}); buffers differing {len(bufs_differ)} of {len(plain[2])}; growth launches "
        f"plain {plain[4]}, remat {remat[4]}; output dtypes in remat blocks {calls}")
    say("remat", f"[{smi}] bf16 gradients: remat vs plain worst leaf relative L2 {b_rel:.3e} "
        f"({b_leaf}), "
        f"plain vs its {REMAT_REPEATS} repeats at most {b_floor:.3e} (limit 2x); BatchNorm-fed "
        f"biases {b_dust:.3e} vs repeats {b_dust_floor:.3e}")
    say("remat", f"[{smi}] fp32 gradients: remat vs plain worst leaf relative L2 {f_rel:.3e} "
        f"({f_leaf}), "
        f"plain vs its {REMAT_REPEATS} repeats at most {f_floor:.3e} (limit 2x); BatchNorm-fed "
        f"biases {f_dust:.3e} vs repeats {f_dust_floor:.3e}; fp32 growth launches plain "
        f"{f_plain[4]}, remat {f_remat[4]}")
    say("remat", f"[{smi}] bf16 peak memory plain {plain[3] / 2**30:.3f} GiB, remat "
        f"{remat[3] / 2**30:.3f} GiB ({remat[3] / plain[3]:.3f}); fp32 {f_plain[3] / 2**30:.3f} -> "
        f"{f_remat[3] / 2**30:.3f} GiB; bf16 step plain {ms['plain']:.3f} ms, remat "
        f"{ms['remat']:.3f} ms ({ms['remat'] / ms['plain']:.3f}), mean of {REMAT_STEPS} by CUDA "
        "events")
    require(loss_equal, "remat loss bit-equal to the plain step's")
    require(not bufs_differ, f"remat running statistics bit-equal (differ: {bufs_differ[:3]})")
    require(len(calls["conv"]) == 2 and len(calls["linear"]) == 4  # the MLP runs twice a call
            and all(set(v) == {torch.bfloat16} for v in calls.values()),
            "the recomputation runs under the forward's bf16 autocast")
    require(b_rel <= 2.0 * b_floor and b_dust <= 2.0 * b_dust_floor,
            "bf16 remat gradients within twice the plain step's widest repeat distance")
    require(f_rel <= 2.0 * f_floor and f_dust <= 2.0 * f_dust_floor,
            "fp32 remat gradients within twice the plain step's widest repeat distance")
    for run in (plain, f_plain):
        require(run[4] == (16, 16), "16/16 growth launches in a plain step")
    for run in (remat, f_remat):
        require(run[4] == (32, 16), "32/16 growth launches in a remat step")
    require(remat[3] < plain[3] and f_remat[3] < f_plain[3], "remat lowers the step's peak memory")
    return {"peak_gib": (plain[3] / 2**30, remat[3] / 2**30), "ms": (ms["plain"], ms["remat"])}


def phase_train_options(torch, smi):
    """Phase 30: ``run.main`` on noise_synthetic.json cut to 2 epochs of 64
    images (4 steps each) with ``remat``, a cosine ``lr_schedule``,
    ``grad_clip`` 1.0, ``logging.profiler`` on epoch 2 and checkpoints every
    epoch; then 1 epoch resumed from ``state_001``.  Checks the artifacts, the
    trace's growth kernels, the resumed steps 4-8 and their learning rates
    (read by an optimizer pre-step hook), the launches of each run."""
    import io
    import shutil

    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from multi_degradation_image_enhancement_tpu_torch import run
    from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd,
    )
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    work = Path("build") / "chip_smoke_train_options"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = read_config("noise_synthetic")
    cfg["train"].update(n_epoch=2, model_path=str(work / "weights"), remat=True,
                        lr_schedule="cosine", grad_clip=1.0)
    cfg["train"]["dataset"]["args"]["n_images"] = CLI_IMAGES
    cfg["logging"]["root_dir"] = str(work / "runs")
    cfg["logging"]["profiler"] = {"enabled": True, "trace_epochs": [2]}
    cfg["logging"]["checkpoints"] = {"enabled": True, "every_n_epochs": 1}
    steps = CLI_IMAGES // cfg["train"]["dataloader"]["args"]["batch_size"]
    passes = cfg["train"]["bn_recalibration"]["passes"]
    lr = cfg["train"]["lr"]

    def train(config_path, log):
        lrs = []
        handle = register_optimizer_step_pre_hook(
            lambda opt, args, kwargs: lrs.append(opt.param_groups[0]["lr"]))
        growth_layer_fwd.launches = growth_layer_bwd.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                engine = run.main(load_config(str(config_path), phase="train"))
            torch.cuda.synchronize()
        finally:
            handle.remove()
        return engine, lrs, (growth_layer_fwd.launches, growth_layer_bwd.launches), \
            time.perf_counter() - t0

    (work / "config.json").write_text(json.dumps(cfg))
    log = io.StringIO()
    engine, lrs, launches, seconds = train(work / "config.json", log)
    (run_dir,) = (work / "runs" / "noise_synthetic").iterdir()
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    plots = sorted(p.name for p in (run_dir / "plots").glob("loss_total.*"))
    trace = run_dir / "profile" / "epoch_002.json"
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    traced = {k: sum(k in n for n in names) for k in GROWTH_KERNELS[:2]}
    want = (32 * 2 * steps + 16 * passes * steps, 16 * 2 * steps)
    say("train_options", f"[{smi}] 2 epochs x {steps} steps, remat + cosine + clip 1.0 + profiler: "
        f"{seconds:.1f} s, step {engine.state.step}, checkpoints {ckpts}, plots {plots}, trace "
        f"{trace.stat().st_size / 2**20:.1f} MiB names {traced}; growth launches {launches} "
        f"(expected {want}: 32 fwd a remat step + 16 a recalibration forward, 16 bwd a step); "
        f"lrs {[f'{v:.3e}' for v in lrs]}")
    require(ckpts == ["epoch_001.pt", "epoch_002.pt", "state_001", "state_002"],
            "epoch weight files and full states")
    require(bool(plots), "the loss plot (PNG, or its JSON where matplotlib is absent)")
    require(all(traced.values()), "the epoch-2 trace names growth_fwd_kernel and growth_bwd_kernel")
    require(launches == want, "growth launches of the remat run")
    require(engine.state.step == 2 * steps and len(lrs) == 2 * steps, "8 steps")

    cfg["train"].update(n_epoch=1, resume=str(run_dir / "checkpoints" / "state_001"),
                        model_path=str(work / "weights_resumed"))
    cfg["logging"]["root_dir"] = str(work / "runs_resumed")
    cfg["logging"]["profiler"] = {"enabled": False}
    (work / "resume.json").write_text(json.dumps(cfg))
    log = io.StringIO()
    resumed, lrs, launches, seconds = train(work / "resume.json", log)
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith(("[CKPT]", "Epoch"))]

    def cosine(c, total=steps):  # optax's cosine_decay_schedule, alpha 0.01, T of this run
        return lr * (0.99 * 0.5 * (1.0 + math.cos(math.pi * min(c, total) / total)) + 0.01)

    want_lrs = [cosine(c) for c in range(steps, 2 * steps)]
    want = (32 * steps + 16 * passes * steps, 16 * steps)
    weights = work / "weights_resumed" / cfg["train"]["model_name"]
    load_weights(str(weights), CDAN())  # strict
    say("train_options", f"[{smi}] resumed 1 epoch in {seconds:.1f} s: {lines}; step "
        f"{resumed.state.step}; lrs {lrs} vs the schedule's {want_lrs}; growth launches "
        f"{launches} (expected {want}); {weights} loads strictly")
    require(any(ln.startswith("[CKPT] Resumed from") and ln.endswith(f"at step {steps}")
                for ln in lines), "the resume line at step 4")
    require(resumed.state.step == 2 * steps, "the resumed run ends at step 8")
    require(len(lrs) == steps and all(math.isclose(a, b, rel_tol=1e-12)
                                      for a, b in zip(lrs, want_lrs)),
            "the learning rates of counts 4-7")
    require(launches == want, "growth launches of the resumed run")


# ------------------------------------------------------- phases 31-33: scale-out

SCALE_TIMEOUT = 420  # seconds a torchrun launch of phases 31-33 may take
SCALE_RUNS = (("sharded", {"data": -1}), ("plain", None), ("repeat", None))  # phase 31


def torchrun(nproc: int, args):
    """``torchrun --standalone --nproc_per_node nproc`` on this script's
    worker mode; returns (stdout, seconds).  torchrun ends every rank when
    one fails; a launch still running at ``SCALE_TIMEOUT`` is killed, and
    either fails the phase."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), str(Path(__file__).resolve()), "--worker", *map(str, args)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=SCALE_TIMEOUT)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"{args[0]} on {nproc} ranks exits 0:\n{proc.stdout[-2000:]}\n"
            f"{proc.stderr[-4000:]}")
    return proc.stdout, seconds


def _scale_config(work: Path, mesh=None) -> Path:
    """noise_synthetic.json cut to one epoch of 64 images (phase 10's run),
    with ``train.mesh`` when given; every output under ``work``."""
    cfg = read_config("noise_synthetic")
    cfg["train"].update(n_epoch=1, model_path=str(work / "weights"))
    if mesh:
        cfg["train"]["mesh"] = mesh
    cfg["train"]["dataset"]["args"]["n_images"] = CLI_IMAGES
    cfg["logging"]["root_dir"] = str(work / "runs")
    work.mkdir(parents=True, exist_ok=True)
    path = work / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def worker_nccl_train(torch, work: Path):
    """Phase 31's rank (``torchrun --nproc_per_node 1``): ``run.main`` with
    ``train.mesh {"data": -1}`` (``run`` joins the process group: NCCL), then
    twice without it, the growth launches counted around each; then the
    sharded and the plain step timed on one loader batch, in turns."""
    import torch.distributed as dist

    from multi_degradation_image_enhancement_tpu_torch import run
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd,
    )
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import shard_batch
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    out, engines = {"runs": {}}, {}
    for name, mesh in SCALE_RUNS:
        config = load_config(str(_scale_config(work / name, mesh)), phase="train")
        torch.cuda.synchronize()
        growth_layer_fwd.launches = growth_layer_bwd.launches = 0
        t0 = time.perf_counter()
        engines[name] = run.main(config)
        torch.cuda.synchronize()
        out["runs"][name] = {"seconds": time.perf_counter() - t0,
                             "launches": (growth_layer_fwd.launches, growth_layer_bwd.launches)}
    mesh = engines["sharded"].mesh
    out.update(backend=dist.get_backend(), world=dist.get_world_size(),
               mesh=None if mesh is None else mesh.shape,
               plain_sharded=engines["plain"].mesh is not None)
    inputs, targets, mask = next(iter(engines["plain"].dataloader))
    gen = torch.Generator(device="cuda").manual_seed(5)
    out["ms"] = {"plain": [], "sharded": []}
    for name in ("plain", "sharded", "sharded", "plain"):
        e = engines[name]
        batch = shard_batch((inputs, targets, mask), e.mesh) if e.mesh else (inputs, targets, mask)
        out["ms"][name].append(
            cuda_ms(lambda: e._train_step(e.state, batch[0], batch[1], gen, batch[2]), 10, 2))
    from torch.profiler import ProfilerActivity, profile

    for name in ("plain", "sharded"):  # where the sharded step's extra time goes
        e = engines[name]
        batch = shard_batch((inputs, targets, mask), e.mesh) if e.mesh else (inputs, targets, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                e._train_step(e.state, batch[0], batch[1], gen, batch[2])
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
        events = prof.key_averages()
        device = sum(ev.self_device_time_total for ev in events) / 1e3 / 3
        nccl = [ev for ev in events if "nccl" in ev.key.lower()]
        out.setdefault("profile", {})[name] = {
            "wall_ms": wall, "device_ms": device,
            "nccl": sorted(((ev.key, ev.count // 3, ev.self_cpu_time_total / 1e3 / 3,
                             ev.self_device_time_total / 1e3 / 3) for ev in nccl),
                           key=lambda r: -r[2])[:6],
            "cpu_top": sorted(((ev.key, ev.count // 3, ev.self_cpu_time_total / 1e3 / 3)
                               for ev in events), key=lambda r: -r[2])[:8]}
    torch.save(out, work / "result.pt")


def _restored(torch, weights: Path):
    """A checkpoint's f32 module (TF32 off) on a fixed batch of 2: what two
    training runs are compared by."""
    from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN, eval_forward

    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.rand((2, *EVAL_HW, 3), device="cuda", generator=gen)
    return eval_forward(load_weights(str(weights), CDAN()).to("cuda").eval(), torch.float32)(x)


def phase_nccl_world1(torch, smi):
    """Phase 31: NCCL at world 1.  ``torchrun --nproc_per_node 1`` on
    phase 10's CLI run with ``train.mesh {"data": -1}`` (bf16, fused
    DenseBlocks, BN recalibration), then the same run twice without the mesh
    in the same process.  The sharded run's growth launches are phase 10's;
    its checkpoint restores images within max(2e-3, twice the two plain
    runs' distance) of the plain run's (the card's step does not repeat
    itself bit for bit, and Adam moves near-zero gradients by up to lr); the
    sharded step's ms beside the plain step's (CUDA events, in turns): what
    sync-BN's all-reduces and the gradient's cost at world 1 on one H100."""
    import shutil

    work = Path("build") / "chip_smoke_scale" / "nccl"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    _, seconds = torchrun(1, ["nccl_train", work])
    res = torch.load(work / "result.pt")
    cfg = read_config("noise_synthetic")["train"]
    steps = CLI_IMAGES // cfg["dataloader"]["args"]["batch_size"]
    want = (16 * (steps + cfg["bn_recalibration"]["passes"] * steps), 16 * steps)
    imgs = {n: _restored(torch, work / n / "weights" / cfg["model_name"]) for n, _ in SCALE_RUNS}
    d_sharded = (imgs["sharded"] - imgs["plain"]).abs().max().item()
    d_repeat = (imgs["repeat"] - imgs["plain"]).abs().max().item()
    limit = max(2e-3, 2.0 * d_repeat)
    ms = {k: v for k, v in res["ms"].items()}
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    runs = res["runs"]
    say("scale", f"[{smi}] phase 31: backend {res['backend']}, world {res['world']}, mesh "
        f"{res['mesh']}; torchrun {seconds:.1f} s; CLI runs "
        + ", ".join(f"{n} {r['seconds']:.1f} s launches {r['launches']}" for n, r in runs.items())
        + f" (expected {want}); restored images: sharded vs plain max |d| {d_sharded:.3e}, "
        f"plain vs its repeat {d_repeat:.3e} (limit {limit:.3e})")
    say("times", f"[{smi}] phase 31 train step B={TRAIN_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} bf16 "
        f"fused, NCCL world 1: sharded {ms['sharded'][0]:.3f}/{ms['sharded'][1]:.3f} ms, plain "
        f"{ms['plain'][0]:.3f}/{ms['plain'][1]:.3f} ms (in turns; means {mean['sharded']:.3f} "
        f"vs {mean['plain']:.3f}, x{mean['sharded'] / mean['plain']:.3f}), 10 steps each by "
        "CUDA events")
    for name, prof in res["profile"].items():
        say("scale", f"[{smi}] phase 31 torch.profiler, {name} step (mean of 3): wall "
            f"{prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms (busy share "
            f"{prof['device_ms'] / prof['wall_ms']:.3f}); NCCL ops (name, calls a step, host ms, "
            f"device ms) {prof['nccl']}; host-heaviest ops {prof['cpu_top']}")
    require(res["backend"] == "nccl" and res["world"] == 1 and res["mesh"] == {"data": 1},
            "the sharded run joined NCCL at world 1 with the mesh {'data': 1}")
    require(not res["plain_sharded"], "the runs without train.mesh run the plain step")
    require(all(r["launches"] == want for r in runs.values()), "growth launches of each run")
    require(d_sharded <= limit, "the sharded run restores as the plain run does")
    return {"ms": mean, "d_sharded": d_sharded, "d_repeat": d_repeat, "profile": res["profile"]}


def _scale_inputs(torch, seed: int):
    """The full-width CDAN (Flax init) and a global batch B=16·256x384 with its
    four keep masks, the same on every process (drawn on the card from
    ``seed``)."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    from multi_degradation_image_enhancement_tpu_torch.models.torch_init import flax_default_init_

    dev = torch.device("cuda")
    model = flax_default_init_(CDAN(), torch.Generator().manual_seed(seed)).to(dev)
    model.fused_dense = True
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((TRAIN_BATCH, *EVAL_HW, 3), device=dev, generator=gen)
    t = torch.clamp(x + 0.1 * torch.randn(x.shape, device=dev, generator=gen), 0.0, 1.0)
    masks = [torch.rand((TRAIN_BATCH, c, EVAL_HW[0] // p, EVAL_HW[1] // p), device=dev,
                        generator=gen) < 0.8 for c, p in ((64, 2), (128, 4), (256, 8), (512, 8))]
    return model, (x, t), masks


def _scale_step(torch, model, batch, masks, mesh=None, fused=True):
    """One fp32 ``make_train_step`` on a copy of ``model`` (sharded over
    ``mesh`` when given): loss, gradients, running statistics, growth
    launches, ms of the step (host clock around a synchronised step)."""
    import copy

    from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
    from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import (
        shard_batch, shard_train_step,
    )

    m = copy.deepcopy(model)
    m.fused_dense = fused
    state = TrainState.create(m, 1e-3)
    step = make_train_step(build_loss_pipeline(_loss_config(), "cuda"), "fp32")
    if mesh is not None:
        step, batch = shard_train_step(step, mesh), shard_batch(batch, mesh)
    torch.cuda.synchronize()
    growth_layer_fwd.launches = growth_layer_bwd.launches = 0
    t0 = time.perf_counter()
    loss = step(state, *batch, masks, None)
    torch.cuda.synchronize()
    return {"loss": {k: float(v) for k, v in loss.items()},
            "grads": {n: p.grad.detach().cpu() for n, p in m.named_parameters()},
            "stats": {n: b.cpu() for n, b in m.named_buffers() if "running" in n},
            "launches": (growth_layer_fwd.launches, growth_layer_bwd.launches),
            "ms": (time.perf_counter() - t0) * 1e3}


def worker_gloo_steps(torch, work: Path):
    """Phase 32's ranks (two processes on the one card, ``gloo``): the fp32
    fused train step on ``{"data": 2}`` and on ``{"spatial": 2}`` (each
    twice: the first warms up), and the halo'd growth layer (#4/#5, #6/#7)
    against its plain version on ``{"spatial": 2}``."""
    import torch.distributed as dist

    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer, growth_layer_plain, growth_layer_sharded,
    )
    from multi_degradation_image_enhancement_tpu_torch.parallel import collectives, distributed
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import create_mesh

    distributed.initialize(backend="gloo")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model, batch, masks = _scale_inputs(torch, 32)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(), "steps": {}}
    for axes in ({"data": 2}, {"spatial": 2}):
        mesh = create_mesh(axes)
        _scale_step(torch, model, batch, masks, mesh)  # warm-up
        for fused in (True, False):
            out["steps"][(json.dumps(axes), fused)] = _scale_step(torch, model, batch, masks, mesh,
                                                                  fused)
    mesh = create_mesh({"spatial": 2})
    gen = torch.Generator(device="cuda").manual_seed(33)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for c in (64, 112):  # dense1's first and last growth layer, B=16 at 128x192
        inp = _growth_inputs(torch, TRAIN_BATCH, c, 128, 192, gen)
        with collectives.use_mesh(mesh):
            local = list(inp)  # x and the cotangent r: this rank's rows
            local[0], local[-1] = (collectives.local_slice(t, 2).contiguous()
                                   for t in (inp[0], inp[-1]))
            g, grads = _growth_run(torch, lambda *a: growth_layer_sharded(growth_layer, *a),
                                   *local)
            g_ref, ref = _growth_run(torch, lambda *a: growth_layer_sharded(growth_layer_plain, *a),
                                     *local)
        torch.cuda.synchronize()
        worst["fwd"] = max(worst["fwd"], (g - g_ref).abs().max().item())
        for got, want in zip(grads, ref):
            rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
            worst["bwd"] = max(worst["bwd"], rel)
    out["growth_halo"] = worst
    torch.save(out, work / f"rank{dist.get_rank()}.pt")


def _leaf_distance(got, want, dust):
    """Each leaf's relative L2 distance ||got - want|| / ||want|| outside
    ``dust``, and the largest |got - want| over ``dust``."""
    return ({n: ((got[n] - g).norm() / g.norm()).item() for n, g in want.items()
             if n not in dust},
            max((got[n] - want[n]).abs().max().item() for n in dust))


SCALE_SHUFFLES = 4  # phase 32's yardstick: the batch reversed, its halves swapped, 4 shuffles


def _batch_orders(torch):
    """The global batch's reorderings of phase 32's yardstick."""
    n = TRAIN_BATCH
    return [torch.arange(n - 1, -1, -1), torch.arange(n).roll(n // 2),
            *(torch.randperm(n, generator=torch.Generator().manual_seed(32 + i))
              for i in range(SCALE_SHUFFLES))]


def phase_gloo_steps(torch, smi):
    """Phase 32: two ranks on the one card over ``gloo``.  The full-width
    CDAN train step at B=16·256x384, fp32, cuDNN deterministic, on
    ``{"data": 2}`` and on ``{"spatial": 2}``, with fused and with canonical
    DenseBlocks, against the one-process step on the same weights, batch
    and dropout masks.  Each gradient leaf's relative L2 distance is held
    to twice its own plain-vs-plain distance (never below one fp32 unit),
    measured here: the largest distance of the one-process step from its
    exact repeat and from itself on the batch reordered six ways (a sharded
    step takes the same sums in another order; a leaf whose gradient
    cancels to a few 1e-5 of the others moves by percents under any
    reordering, where the exact repeat moves it by 1e-4 or less, PERF.md
    section 6; an L2 distance, unlike a largest element's, is steady from
    one reordering to the next).  The 24 BatchNorm-fed conv biases,
    zero in exact arithmetic, are held absolutely to twice their largest
    distance.  The loss and the running statistics are held to twice their
    worst distance, never tighter than tests/test_parallel.py holds JAX's
    sharded CDAN step (1e-4 relative, 1e-5 of the largest).  Every leaf's
    reading is printed beside its limit.  16/16 growth launches a rank in
    the fused step; the halo'd growth layer's kernels against its plain
    version on each rank (phase 8's tolerances)."""
    import shutil

    work = Path("build") / "chip_smoke_scale" / "gloo"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    _, seconds = torchrun(2, ["gloo_steps", work])
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model, batch, masks = _scale_inputs(torch, 32)
        orders = [o.cuda() for o in _batch_orders(torch)]
        ref = {fused: [_scale_step(torch, model, batch, masks, None, fused) for _ in range(2)]
               + [_scale_step(torch, model, [t[o] for t in batch], [m[o] for m in masks], None,
                              fused) for o in orders]
               for fused in (True, False)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    dust = _bn_fed_biases(model)
    unit = 2.0 ** -23  # one fp32 unit
    failed, records = [], {}
    for fused in (True, False):
        kind = "fused" if fused else "canonical"
        plain, others = ref[fused][0], ref[fused][1:]
        scale = {n: g.abs().max().item() for n, g in plain["grads"].items()}
        # the card's plain-vs-plain distance, per leaf: the largest over the
        # exact repeat and the six reordered batches
        dist, dust_dist, loss_dist, stats_dist = {}, 0.0, 0.0, 0.0
        for other in others:
            leaves, dust_err = _leaf_distance(other["grads"], plain["grads"], dust)
            for n, v in leaves.items():
                dist[n] = max(dist.get(n, 0.0), v)
            dust_dist = max(dust_dist, dust_err)
            loss_dist = max(loss_dist, *(abs(other["loss"][k] - v) / abs(v)
                                         for k, v in plain["loss"].items()))
            stats_dist = max(stats_dist, *(((other["stats"][n] - st).abs().max()
                                            / st.abs().max()).item()
                                           for n, st in plain["stats"].items()))
        limit = {n: 2.0 * max(d, unit) for n, d in dist.items()}
        say("scale", f"[{smi}] phase 32 one-process {kind} step against its repeat and "
            f"against itself on the batch reversed, its halves swapped and {SCALE_SHUFFLES} "
            f"shuffles (the yardstick): gradient leaves' relative L2 distance "
            f"{min(dist.values()):.3e}-{max(dist.values()):.3e}, "
            f"BatchNorm-fed biases {dust_dist:.3e}, loss rel {loss_dist:.3e}, running "
            f"statistics rel {stats_dist:.3e}")
        readings = {}
        for axes in ('{"data": 2}', '{"spatial": 2}'):
            for r, res in enumerate(ranks):
                got = res["steps"][(axes, fused)]
                leaves, dust_err = _leaf_distance(got["grads"], plain["grads"], dust)
                readings[(axes, r)] = leaves
                over = [n for n, v in leaves.items() if v > limit[n]]
                ratio, leaf = max((v / limit[n], n) for n, v in leaves.items())
                loss_rel = max(abs(got["loss"][k] - v) / abs(v) for k, v in plain["loss"].items())
                stats_rel = max(((got["stats"][n] - st).abs().max() / st.abs().max()).item()
                                for n, st in plain["stats"].items())
                loss_limit, stats_limit = max(2.0 * loss_dist, 1e-4), max(2.0 * stats_dist, 1e-5)
                say("scale", f"[{smi}] phase 32 {res['backend']} world {res['world']} mesh {axes} "
                    f"{kind} rank {r}: loss rel {loss_rel:.3e} (limit {loss_limit:.3e}); "
                    f"gradient leaves over their limit {len(over)} of {len(leaves)}, nearest "
                    f"{leaf} relative L2 {leaves[leaf]:.3e} (limit {limit[leaf]:.3e}, largest "
                    f"{scale[leaf]:.2e}); BatchNorm-fed biases {dust_err:.3e} (limit "
                    f"{2.0 * dust_dist:.3e}); running statistics rel {stats_rel:.3e} (limit "
                    f"{stats_limit:.3e}); growth launches {got['launches']}; step "
                    f"{got['ms']:.1f} ms (two ranks sharing one card)")
                checks = [(loss_rel <= loss_limit, "the loss"),
                          (not over, f"the gradient leaves {over}"),
                          (dust_err <= 2.0 * dust_dist, "the BatchNorm-fed biases"),
                          (stats_rel <= stats_limit, "the running statistics (sync-BN)"),
                          (got["launches"] == ((16, 16) if fused else (0, 0)), "growth launches")]
                failed += [f"{axes} {kind} rank {r}: {what} within twice the card's "
                           "plain-vs-plain distance" for ok, what in checks if not ok]
                records[(axes, fused, r)] = got["ms"]
        for n in sorted(limit, key=lambda n: -scale[n]):
            cols = ", ".join(f"{json.loads(a)} rank {r} {v[n]:.3e}"
                             for (a, r), v in readings.items())
            say("scale", f"phase 32 {kind} leaf {n} (largest {scale[n]:.2e}): relative L2 "
                f"limit {limit[n]:.3e}; {cols}")
    halo = ranks[0]["growth_halo"], ranks[1]["growth_halo"]
    say("scale", f"[{smi}] phase 32: halo'd growth layer kernels vs plain, spatial 2, B=16 "
        f"128x192 c=64/112: fwd max {[h['fwd'] for h in halo]} (limit 5e-2), bwd "
        f"err/max(scale,1) {[h['bwd'] for h in halo]} (limit 2e-2); one-process step fused "
        f"{ref[True][1]['ms']:.1f} ms, canonical {ref[False][1]['ms']:.1f} ms; torchrun "
        f"{seconds:.1f} s")
    require(all(h["fwd"] <= 5e-2 and h["bwd"] <= 2e-2 for h in halo),
            "the halo'd growth kernels hold against their plain version")
    require(not failed, "; ".join(failed))
    return {"ms": records, "plain_ms": {k: v[1]["ms"] for k, v in ref.items()}}


def worker_router(torch, work: Path):
    """Phase 33's ranks for the padded bank: phase 24's first three experts
    on ``{"expert": 2}`` (n_pad 1), top1, the routed server's first batch."""
    import torch.distributed as dist

    from multi_degradation_image_enhancement_tpu_torch.parallel import distributed
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import create_mesh
    from multi_degradation_image_enhancement_tpu_torch.pipeline import (
        RoutedRestorer, expert_block, load_expert_bank,
    )

    distributed.initialize(backend="gloo")
    data = torch.load(work / "inputs.pt")
    mesh = create_mesh({"expert": 2})
    paths = data["paths"]
    names, forwards = load_expert_bank(paths, "cuda", torch.bfloat16,
                                       only=expert_block(len(paths), mesh))
    router = RoutedRestorer(forwards, names, mesh=mesh)
    with torch.inference_mode():
        out = router(data["images"].cuda(), data["probs"].cuda(), [0.5] * len(names))
    torch.save({"out": out.cpu(), "n_pad": router.n_pad, "owned": list(router.owned),
                "backend": dist.get_backend()}, work / f"rank{dist.get_rank()}.pt")


def worker_expert_cli(torch, out: Path, *argv: str):
    """Phase 33's ranks for the CLI: join the process group over ``gloo``
    (three ranks share the one card; NCCL refuses two ranks on one device),
    then ``run_pipeline.main`` with ``argv`` and ``--out out``, which keeps
    the group it finds."""
    from multi_degradation_image_enhancement_tpu_torch import run_pipeline
    from multi_degradation_image_enhancement_tpu_torch.parallel import distributed

    distributed.initialize(backend="gloo")
    run_pipeline.main([*argv, "--out", str(out)])


def phase_expert_parallel(torch, smi, art):
    """Phase 33: the expert-parallel server.  ``run_pipeline --expert-mesh 3``
    under ``torchrun --nproc_per_node 3`` (three ranks sharing the one card
    over ``gloo``: NCCL refuses two ranks on one device) on phase 24's
    64 PNGs and nine experts, top1 and sequential ``severity``: its PNGs
    within 1 LSB of phase 24's one-process CLI's, its probs.jsonl the same,
    written by rank 0 alone; ``--expert-mesh 2`` refused (2 does not divide
    9) before any process group.  Then a 2-rank ``RoutedRestorer`` on three
    experts (n_pad 1) against the unsharded router.  Times are of ranks
    sharing one card, not scaling."""
    import shutil

    import numpy as np
    from PIL import Image

    from multi_degradation_image_enhancement_tpu_torch import run_pipeline
    from multi_degradation_image_enhancement_tpu_torch.pipeline import (
        RoutedRestorer, load_expert_bank,
    )

    work = Path("build") / "chip_smoke_scale" / "expert"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pipe_dir = Path("build") / "chip_smoke_pipeline"
    base = ["--images", art["images"], "--classifier", art["classifier"], "--weights-dir",
            art["weights"], "--batch", PIPE_BATCH, "--input-hw", *EVAL_HW, "--save-probs"]
    try:
        run_pipeline.main([str(a) for a in base] + ["--out", str(work / "refused"),
                                                    "--expert-mesh", "2"])
        refused = "not refused"
    except ValueError as e:
        refused = str(e)
    say("scale", f"phase 33: --expert-mesh 2 with 9 experts: {refused}")
    require("does not divide the 9 loaded experts" in refused, "--expert-mesh 2 is refused")
    records = {}
    for mode, ordering in (("top1", "fixed"), ("sequential", "severity")):
        out = work / mode
        stdout, seconds = torchrun(3, ["expert_cli", out, *base, "--mode", mode, "--ordering",
                                       ordering, "--expert-mesh", 3])
        ref = pipe_dir / f"main_{mode}"
        worst = 0
        for f in art["files"]:
            png = f.rsplit(".", 1)[0] + ".png"
            a = np.asarray(Image.open(out / png), dtype=np.int16)
            b = np.asarray(Image.open(ref / png), dtype=np.int16)
            worst = max(worst, int(np.abs(a - b).max()))
        rows = [[json.loads(line) for line in (d / "probs.jsonl").read_text().splitlines()]
                for d in (out, ref)]
        probs_err = max(abs(a["probs"][k] - b["probs"][k]) for a, b in zip(*rows)
                        for k in a["probs"])
        oks = stdout.count("[OK] restored")
        say("scale", f"[{smi}] phase 33 {mode}/{ordering}: gloo world 3, mesh {{'expert': 3}}, "
            f"{len(art['files'])} PNGs B={PIPE_BATCH} in {seconds:.1f} s (torchrun, three ranks "
            f"sharing one card); vs phase 24's one-process CLI max |d| {worst} LSB (limit 1), "
            f"probs max |d| {probs_err:.2e}; '[OK]' lines {oks}")
        require([a["file"] for a in rows[0]] == [b["file"] for b in rows[1]],
                "one probs row per image, in order")
        require(len(list(out.glob("*.png"))) == len(art["files"]), "one PNG per image")
        require(worst <= 1, "expert-parallel PNGs within 1 LSB of the one-process CLI's")
        require(oks == 1, "rank 0 alone reports and writes")
        records[mode] = seconds

    names = ["noise", "blur", "low_light"]
    paths = {n: str(art["weights"] / f"CDAN_{n}.pt") for n in names}
    images = torch.rand((8, *EVAL_HW, 3), generator=torch.Generator().manual_seed(33))
    probs = torch.full((8, 3), 0.1)
    for i in range(8):
        probs[i, i % 3] = 0.9
    probs[7] = 0.1  # clean
    torch.save({"paths": paths, "images": images, "probs": probs}, work / "inputs.pt")
    _, seconds = torchrun(2, ["router", work])
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    names_, forwards = load_expert_bank(paths, "cuda", torch.bfloat16)
    with torch.inference_mode():
        want = RoutedRestorer(forwards, names_)(images.cuda(), probs.cuda(), [0.5] * 3).cpu()
    errs = [(r["out"] - want).abs().max().item() for r in ranks]
    say("scale", f"[{smi}] phase 33 router: {ranks[0]['backend']} world 2, mesh {{'expert': 2}}, "
        f"3 experts: n_pad {[r['n_pad'] for r in ranks]}, blocks {[r['owned'] for r in ranks]}, "
        f"vs the unsharded router max |d| {errs} (limit 1/255); torchrun {seconds:.1f} s")
    require([r["n_pad"] for r in ranks] == [1, 1] and [r["owned"] for r in ranks] == [[0, 1], [2]],
            "the padded bank's blocks")
    require(max(errs) <= 1.0 / 255.0, "the 2-rank router restores as the unsharded one")
    return records


HOST_IO_IMAGES = 64  # phase 34: procedural images, PNG and JPEG, at, above and below 256x384
HOST_IO_THREADS = 4
BF16_ACT_K = 56  # phase 35: the shipped serving_tuning.json's db_k_stack_max_ci
BF16_ACT_STEPS = 3  # phase 35: serving steps counted with bf16 activations
# phase 35: the bf16-activation kernel vs its plain version at bf16 x
BF16_ACT_MAX = 1e-3  # twice its reading, one bf16 ulp at 0.125-0.25 (NVIDIA H100, 700 W)
BF16_ACT_MEAN_SHARE = 0.01  # its reading: below 1e-6 of the f32-activation kernel's mean
LPIPS_BATCH = 4  # phase 36: B=4·256x384, card vs CPU
SCAN_K = 4  # phase 37: train.scan_chunk (one epoch of 64 images at B=16 is one chunk)
# Phases 1-37's tuning: f32 activations (the tuning the port shipped before it
# tuned itself on the card) unless a phase says otherwise; pinned by
# pin_forward() whatever the port's file chose.
PINNED_TUNING = {"db_bf16_act": False, "db_k_stack_max_ci": 56}
TUNE_ITERS = 5  # phase 38: timed steps of each variant in each turn
BENCH_BUDGET = 240  # phase 39: BENCH_BUDGET_S of the bench subprocess
TRAIN_TP = {"rows": ("b16", "b16_fused"), "iters": 2, "chunk": 4}  # phase 40


def _host_io_images(work: Path, n: int, hw):
    """``n`` procedural images, PNG and JPEG (quality 90) in turns, a third
    at ``hw``, a third 1.5× larger, a third at half size; their paths."""
    from PIL import Image

    from multi_degradation_image_enhancement_tpu_torch.data.synthetic import _procedural_clean

    work.mkdir(parents=True, exist_ok=True)
    sizes = (hw, (hw[0] * 3 // 2 + 1, hw[1] * 3 // 2 + 3), (hw[0] // 2 - 1, hw[1] // 2 + 1))
    paths = []
    for i in range(n):
        h, w = sizes[i % 3]
        img = Image.fromarray(_procedural_clean(1, h, w, seed=340 + i)[0])
        path = work / (f"h{i:03d}.png" if i % 2 == 0 else f"h{i:03d}.jpg")
        img.save(path, **({} if i % 2 == 0 else {"quality": 90}))
        paths.append(str(path))
    return paths


def host_io_checks(work: Path, images: int = HOST_IO_IMAGES, hw=EVAL_HW,
                   threads: int = HOST_IO_THREADS) -> dict:
    """Phase 34's checks of the native host-IO engine (host work, no card):
    ``images`` procedural images decoded by the engine at ``hw``, each equal
    to the NumPy plain version of the engine's resize bit for bit (run on the
    engine's own exact-size decode); at size, PNG equal to PIL and JPEG within
    1 LSB of PIL; a missing file zero-filled and counted; PNG encode
    round-trips.  Then decode and encode img/s at ``hw`` on ``threads``
    threads beside PIL on a pool of as many threads (PIL's encode at its
    default level)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from multi_degradation_image_enhancement_tpu_torch.data import io_native

    paths = _host_io_images(work / "images", images, hw)
    got = io_native.decode_batch(paths, *hw, n_threads=threads)
    require(got is not None and got.shape == (images, *hw, 3), "engine batch decode")
    jpeg_lsb = 0
    for i, path in enumerate(paths):
        pil = np.asarray(Image.open(path).convert("RGB"))
        exact = io_native.decode_image(path, *pil.shape[:2], io_native.MODE_EXACT)
        require(np.array_equal(got[i], io_native.resize_bilinear_np(exact, *hw)),
                f"{path}: engine decode equals the NumPy plain version")
        if pil.shape[:2] == tuple(hw):
            d = int(np.abs(exact.astype(np.int16) - pil).max())
            require(d == 0 if path.endswith(".png") else d <= 1, f"{path}: at size vs PIL ({d})")
            jpeg_lsb = max(jpeg_lsb, d)
    before = io_native.decode_failures
    holed = io_native.decode_batch([paths[0], str(work / "missing.png")], *hw, n_threads=2)
    require(io_native.decode_failures == before + 1 and not holed[1].any(),
            "a missing file zero-filled and counted")
    out = [str(work / f"enc{i:03d}.png") for i in range(images)]
    require(io_native.encode_png_batch(out, got, 1, threads) == 0, "engine batch encode")
    for path, frame in zip(out, got):
        require(np.array_equal(np.asarray(Image.open(path)), frame), f"{path} round-trips")

    def pil_decode(path):
        img = Image.open(path).convert("RGB")
        if (img.height, img.width) != tuple(hw):
            img = img.resize((hw[1], hw[0]), Image.BILINEAR)
        return np.asarray(img)

    def pil_encode(args):
        Image.fromarray(args[1]).save(args[0])

    rates = {}
    with ThreadPoolExecutor(threads) as pool:
        for name, fn in (
                ("engine_decode", lambda: io_native.decode_batch(paths, *hw, n_threads=threads)),
                ("pil_decode", lambda: list(pool.map(pil_decode, paths))),
                ("engine_encode", lambda: io_native.encode_png_batch(out, got, 1, threads)),
                ("pil_encode", lambda: list(pool.map(pil_encode, zip(out, got))))):
            fn()  # warm the page cache and the pool
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            rates[name] = 3 * images / (time.perf_counter() - t0)
    return {"jpeg_max_lsb": jpeg_lsb, "img_s": rates}


def phase_host_io(torch, smi, pipe_records, dir_record):
    """Phase 34: the native host-IO engine (``data.io_native``).  Where it
    builds: :func:`host_io_checks`, and phase 24's in-process routed CLI and
    phase 28's ``-p test`` decoded through it (their counts read around
    them).  Where ``g++`` lacks ``jpeglib.h`` / ``png.h`` (or the libraries),
    the engine is unavailable, as in the JAX package, every caller takes
    PIL, and the phase prints the build's first error line and runs no
    engine check."""
    import shutil

    from multi_degradation_image_enhancement_tpu_torch.data import io_native

    if not io_native.available():
        error = (io_native.build_error() or "MDIE_NATIVE_IO=0").strip().splitlines()
        first = next((ln for ln in error if "error:" in ln), error[0])  # the compiler's own
        say("host_io", f"native engine unavailable on this machine, PIL decodes and encodes "
            f"(phases 24 and 28 made {pipe_records['top1']['io']} / {dir_record['io']} engine "
            f"calls); no engine check run; the build's first error: {first.strip()}")
        require(pipe_records["top1"]["io"]["decode"] == 0 and dir_record["io"]["decode"] == 0,
                "no engine call without the engine")
        return None
    work = Path("build") / "chip_smoke_host_io"
    shutil.rmtree(work, ignore_errors=True)
    res = host_io_checks(work)
    r = res["img_s"]
    say("host_io", f"[{smi}] {HOST_IO_IMAGES} images (PNG and JPEG; at, above and below "
        f"{EVAL_HW[0]}x{EVAL_HW[1]}): engine decode = NumPy plain version bit for bit, at size "
        f"PNG = PIL, JPEG within {res['jpeg_max_lsb']} LSB of PIL (limit 1), encode round-trips")
    say("times", f"[{smi}] host IO at {EVAL_HW[0]}x{EVAL_HW[1]}, {HOST_IO_THREADS} threads: "
        f"decode engine {r['engine_decode']:.1f} img/s vs PIL {r['pil_decode']:.1f}; encode "
        f"engine (level 1) {r['engine_encode']:.1f} img/s vs PIL {r['pil_encode']:.1f}")
    for name, calls in (("phase 24 routed CLI", pipe_records["top1"]["io"]),
                        ("phase 28 -p test", dir_record["io"])):
        say("host_io", f"{name}: engine calls {calls}")
        require(calls["decode"] > 0, f"{name} decoded through the native engine")
    return res


def bf16_act_blocks(torch, smi, model):
    """Phase 35's kernel checks: at each of the four B=128·256² block shapes,
    the bf16-activation kernel vs its plain version at f32 x (the DenseBlock
    limits) and at bf16 x, which rounds where the kernel rounds.  There the
    kernel must come within BF16_ACT_MAX, and its mean distance must be at
    most BF16_ACT_MEAN_SHARE of the f32-activation kernel's from the same
    plain output: a kernel that ignored the flag would fail.  Each block is
    timed with f32 and bf16 activations, in turns, and its plain version.
    Returns (worst distance at f32 x, summed ms, bf16 launches a step)."""
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        dense_block, dense_block_plain, pack_dense_block,
    )

    dev = torch.device("cuda")
    blocks = _cdan_blocks(model)
    packs = {act: {name: pack_dense_block(b, dev, act, BF16_ACT_K) for name, b in blocks.items()}
             for act in (False, True)}
    per_step = sum(p.layer_bf16_act(i) for p in packs[True].values() for i in range(5))
    g = torch.Generator(device=dev).manual_seed(35)
    worst = 0.0
    sums = {"f32_act": 0.0, "bf16_act": 0.0, "plain": 0.0}
    failed = []
    for name, bsz, c_in, (h, w) in DB_SHAPES[:4]:
        x = torch.rand((bsz, c_in, h, w), device=dev, generator=g).to(torch.bfloat16)
        pack = packs[True][name]
        got = dense_block(x, pack)
        ref16 = dense_block_plain(x, pack).float()
        d_on = (got.float() - ref16).abs()
        d_off = (dense_block(x, packs[False][name]).float() - ref16).abs()
        on, off = (d_on.max().item(), d_on.mean().item()), (d_off.max().item(), d_off.mean().item())
        worst = max(worst, _db_check(torch, f"bf16_act {name} B={bsz} c={c_in} {h}x{w} layers "
                                     f"{[pack.layer_bf16_act(i) for i in range(5)]} (vs plain at "
                                     "f32 x)", got, dense_block_plain(x.float(), pack)))
        say("bf16_act", f"{name}: vs plain at bf16 x (the same rounding points), bf16-activation "
            f"kernel max {on[0]:.3e} (limit {BF16_ACT_MAX:.0e}) mean {on[1]:.3e} (limit "
            f"{BF16_ACT_MEAN_SHARE} x {off[1]:.3e} = {BF16_ACT_MEAN_SHARE * off[1]:.3e}); "
            f"f32-activation kernel max {off[0]:.3e} mean {off[1]:.3e}")
        if not (on[0] <= BF16_ACT_MAX and on[1] <= BF16_ACT_MEAN_SHARE * off[1]):
            failed.append(name)
        t = {"f32_act": [], "bf16_act": []}
        for act in ("f32_act", "bf16_act", "bf16_act", "f32_act"):
            p = packs[act == "bf16_act"][name]
            t[act].append(cuda_ms(lambda: dense_block(x, p), 10))
        t = {k: sum(v) / 2 for k, v in t.items()}
        t["plain"] = cuda_ms(lambda: dense_block_plain(x, pack), 5)
        for k in sums:
            sums[k] += t[k]
        say("times", f"[{smi}] dense_block {name} B={bsz} c={c_in} {h}x{w} bf16: f32-activation "
            f"kernel {t['f32_act']:.3f} ms, bf16-activation kernel {t['bf16_act']:.3f} ms, "
            f"plain (bf16 activations) {t['plain']:.3f} ms")
    require(not failed, f"bf16-activation kernels round as their plain version ({failed})")
    return worst, sums, per_step


def phase_bf16_act(torch, smi, model, live, ckpt_dir: Path):
    """Phase 35: the bf16-activation DenseBlock (``db_bf16_act``, with the
    shipped ``db_k_stack_max_ci`` 56).  The kernels vs their plain version at
    the four block shapes of B=128·256² (c_in 64, 128, 256 and 3: the last
    keeps its first three layers in f32) and their times
    (:func:`bf16_act_blocks`).  Then a tuning file under
    ``build/`` with ``db_bf16_act: true`` through ``$MDIE_SERVING_TUNING``:
    the serving forward vs the f32 ``CDAN`` (phase 5's limits), serving steps
    with the counts reset just before (17 bf16-activation launches of 24 a
    step), the step's time beside the f32-activation step's, and ``-p test``
    scoring phase 10's checkpoint through it."""
    import os

    from multi_degradation_image_enhancement_tpu_torch import serving
    from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK, dense_block,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(36)
    worst, sums, per_step = bf16_act_blocks(torch, smi, model)

    work = Path("build") / "chip_smoke_bf16act"
    work.mkdir(parents=True, exist_ok=True)
    tuning = dict(PINNED_TUNING, db_bf16_act=True, db_k_stack_max_ci=BF16_ACT_K)
    tuning_path = work / "serving_tuning.json"
    tuning_path.write_text(json.dumps(tuning))
    old = os.environ.get("MDIE_SERVING_TUNING")
    os.environ["MDIE_SERVING_TUNING"] = str(tuning_path)
    try:
        x = torch.rand((2, *EVAL_HW, 3), device=dev, generator=g)
        live = live.to(dev)
        with torch.inference_mode():
            err = (build_serving_apply(live, torch.bfloat16, dev)(x) - live(x)).abs()
        say("bf16_act", f"serving forward with bf16 activations vs f32 CDAN at "
            f"2x{EVAL_HW[0]}x{EVAL_HW[1]}: max {err.max().item():.3e} (limit 2e-2) mean "
            f"{err.mean().item():.3e} (limit 2e-3)")
        require(err.max().item() <= 2e-2 and err.mean().item() <= 2e-3,
                "bf16-activation serving forward vs module")
        step, clean = serving.build_pipeline(BENCH_BATCH, BENCH_SIZE, torch.bfloat16, "cuda")
        gen = torch.Generator().manual_seed(35)
        step(clean, gen)
        torch.cuda.synchronize()
        # The main path of this slice: the counts reset just before, read just after.
        dense_block.launches = dense_block.bf16_act_launches = 0
        outs = [step(clean, gen) for _ in range(BF16_ACT_STEPS)]
        torch.cuda.synchronize()
        launches = {"dense_block": dense_block.launches,
                    "dense_block_bf16_act": dense_block.bf16_act_launches}
        test = _cli_test(torch, "bf16_act", ckpt_dir, env={"MDIE_SERVING_TUNING": str(tuning_path)})
    finally:
        if old is None:
            os.environ.pop("MDIE_SERVING_TUNING", None)
        else:
            os.environ["MDIE_SERVING_TUNING"] = old
    step_f32, _ = serving.build_pipeline(BENCH_BATCH, BENCH_SIZE, torch.bfloat16, "cuda")
    step_f32(clean, gen)
    ms = {"f32_act": [], "bf16_act": []}
    for act in ("f32_act", "bf16_act", "bf16_act", "f32_act"):
        fn = step if act == "bf16_act" else step_f32
        ms[act].append(cuda_ms(lambda: fn(clean, gen), 10))
    want = 4 * LAUNCHES_PER_BLOCK * BF16_ACT_STEPS
    say("bf16_act", f"{BF16_ACT_STEPS} serving steps B={BENCH_BATCH}x{BENCH_SIZE}^2 with "
        f"db_bf16_act: launches {launches} (expected {want}, of them {per_step * BF16_ACT_STEPS} "
        f"bf16-activation); -p test launches {test['launches']}, scores {test['scores']}")
    say("times", f"[{smi}] serving step B={BENCH_BATCH}x{BENCH_SIZE}^2 bf16: f32 activations "
        f"{ms['f32_act'][0]:.3f}/{ms['f32_act'][1]:.3f} ms, bf16 activations "
        f"{ms['bf16_act'][0]:.3f}/{ms['bf16_act'][1]:.3f} ms (in turns, 10 steps each); four "
        f"DenseBlocks: f32-activation kernels {sums['f32_act']:.3f} ms, bf16-activation "
        f"{sums['bf16_act']:.3f} ms, plain {sums['plain']:.3f} ms")
    for out in outs:
        require(bool(torch.isfinite(out).all()) and out.min().item() >= 0.0
                and out.max().item() <= 1.0, "bf16-activation step outputs finite, in [0, 1]")
    require(launches == {"dense_block": want, "dense_block_bf16_act": per_step * BF16_ACT_STEPS},
            "the serving steps ran the bf16-activation kernels")
    require(per_step == 17, "17 of 24 launches a step activate in bf16 at db_k_stack_max_ci 56")
    require(test["launches"]["dense_block_bf16_act"] == per_step * test["batches"],
            "-p test ran the bf16-activation kernels")
    return {"max_abs_err": worst, "launches": launches["dense_block_bf16_act"],
            "ms": sums["bf16_act"], "plain_ms": sums["plain"], "f32_act_ms": sums["f32_act"],
            "step_ms": {k: sum(v) / 2 for k, v in ms.items()}}


def phase_lpips_backbones(torch, smi, shipped):
    """Phase 36: LPIPS on the VGG16 and SqueezeNet backbones (seeded random
    frozen weights) on the card against the same module on the CPU at
    B=4·256x384, f32 with TF32 off; then ``-p test`` with ``lpips: {net:
    vgg}`` scoring phase 10's checkpoint, and its eval step's ms beside the
    shipped (alex) one's."""
    import copy

    from multi_degradation_image_enhancement_tpu_torch.ops.perceptual import (
        LPIPS, init_frozen_params,
    )

    gen = torch.Generator().manual_seed(36)
    x = torch.rand((LPIPS_BATCH, *EVAL_HW, 3), generator=gen)
    y = (x + 0.1 * torch.randn(x.shape, generator=gen)).clamp(0, 1)
    for net in ("vgg", "squeeze"):
        cpu = init_frozen_params(LPIPS(net), f"lpips_{net}.npz")
        card = copy.deepcopy(cpu).to("cuda")
        with torch.no_grad():
            want = cpu(x, y)
            got = card(x.cuda(), y.cuda()).cpu()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        say("lpips", f"{net}: B={LPIPS_BATCH}x{EVAL_HW[0]}x{EVAL_HW[1]} card vs CPU, f32, TF32 "
            f"off: distances {[round(v, 6) for v in got.tolist()]}, max relative |d| {rel:.2e} "
            "(limit 1e-4)")
        require(bool(torch.isfinite(got).all()) and rel <= 1e-4, f"LPIPS {net} card vs CPU")
    vgg = _cli_test(torch, "lpips_vgg", Path(shipped["engine"].model_path), lpips_net="vgg")
    ms = {}
    for name, rec in (("alex", shipped), ("vgg", vgg)):
        e = rec["engine"]
        eval_step = e._build_eval_step(e._load_for_eval())
        t_in, t_tgt, t_mask = next(iter(e.dataloader))
        ms[name] = cuda_ms(lambda: eval_step(t_in, t_tgt, t_mask), 10, 2)
    say("times", f"[{smi}] eval step B={t_in.shape[0]}x{EVAL_HW[0]}x{EVAL_HW[1]}: lpips alex "
        f"{ms['alex']:.3f} ms, lpips vgg {ms['vgg']:.3f} ms; -p test with vgg scores "
        f"{vgg['scores']}")
    return ms


def phase_scan_chunk(torch, smi):
    """Phase 37: ``train.scan_chunk: 4`` on phase 31's run (noise_synthetic,
    one epoch of 64 images at B=16: one chunk of 4 steps, bf16, fused,
    BN recalibration) in this process, against phase 31's two plain runs:
    its checkpoint restores images as the plain run's bit for bit, or within
    phase 31's limit max(2e-3, twice the plain runs' own distance) where the
    card's step does not repeat itself; the growth launches of the plain
    run; an epoch's ms a step, scan and plain, in turns."""
    from multi_degradation_image_enhancement_tpu_torch import run
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd,
    )
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    base = Path("build") / "chip_smoke_scale" / "nccl"
    work = Path("build") / "chip_smoke_scan"
    cfg_path = _scale_config(work)
    cfg = json.loads(cfg_path.read_text())
    cfg["train"]["scan_chunk"] = SCAN_K
    cfg_path.write_text(json.dumps(cfg))
    train = cfg["train"]
    steps = CLI_IMAGES // train["dataloader"]["args"]["batch_size"]
    want = (16 * (steps + train["bn_recalibration"]["passes"] * steps), 16 * steps)
    torch.cuda.synchronize()
    growth_layer_fwd.launches = growth_layer_bwd.launches = 0
    engine = run.main(load_config(str(cfg_path), phase="train"))
    torch.cuda.synchronize()
    launches = (growth_layer_fwd.launches, growth_layer_bwd.launches)
    imgs = {n: _restored(torch, d / "weights" / train["model_name"])
            for n, d in (("scan", work), ("plain", base / "plain"), ("repeat", base / "repeat"))}
    d_scan = (imgs["scan"] - imgs["plain"]).abs().max().item()
    d_repeat = (imgs["repeat"] - imgs["plain"]).abs().max().item()
    limit = max(2e-3, 2.0 * d_repeat)
    plain_cfg = base / "plain" / "config.json"
    _, plain = run.build_session(load_config(str(plain_cfg), phase="train"))
    ms = {"plain": [], "scan": []}
    for name in ("plain", "scan", "scan", "plain"):
        e = plain if name == "plain" else engine
        ms[name].append(cuda_ms(lambda: e._train_epoch(1), 2, 1) / steps)
    say("scan_chunk", f"[{smi}] scan_chunk {SCAN_K}: {steps} steps B={TRAIN_BATCH}"
        f"x{EVAL_HW[0]}x{EVAL_HW[1]} bf16 fused; growth launches {launches} (expected {want}); "
        f"restored images vs phase 31's plain run max |d| {d_scan:.3e} "
        f"({'bit for bit' if d_scan == 0 else 'not bit for bit'}; plain vs its repeat "
        f"{d_repeat:.3e}, limit {limit:.3e})")
    say("times", f"[{smi}] train epoch ms a step (CUDA events over an epoch of {steps} steps, "
        f"loader included): plain {ms['plain'][0]:.3f}/{ms['plain'][1]:.3f}, scan_chunk "
        f"{SCAN_K} {ms['scan'][0]:.3f}/{ms['scan'][1]:.3f} (in turns)")
    require(launches == want, "growth launches of the scan run")
    require(d_scan <= limit, "scan_chunk restores as the plain run does")
    return {"d_scan": d_scan, "limit": limit, "ms": {k: sum(v) / 2 for k, v in ms.items()}}


def pin_forward() -> None:
    """Pin phases 1-37 to the tuning they were written for
    (:data:`PINNED_TUNING` through a tuning file under ``build/`` named by
    ``$MDIE_SERVING_TUNING``, inherited by every process they start),
    whatever the port's tuning file chose on the card."""
    import os

    path = Path("build") / "chip_smoke_tuning" / "pinned.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(PINNED_TUNING))
    os.environ["MDIE_SERVING_TUNING"] = str(path)


def unpin_forward() -> None:
    """The port's own tuning file again."""
    import os

    os.environ.pop("MDIE_SERVING_TUNING", None)


def _serving_counts(reset: bool = False) -> dict:
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import conv3x3, conv3x3_pool
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import dense_block
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import noise_degrade_01
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.upsample import bilinear_x2_add
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.cbam import cbam_cm

    fns = {"noise_degrade": noise_degrade_01, "dense_block": dense_block,
           "conv3x3_pool": conv3x3_pool, "conv3x3": conv3x3, "bilinear_x2_add": bilinear_x2_add,
           "cbam_cm": cbam_cm}
    if reset:
        for fn in fns.values():
            fn.launches = 0
        dense_block.bf16_act_launches = 0
    out = {k: fn.launches for k, fn in fns.items()}
    out["dense_block_bf16_act"] = dense_block.bf16_act_launches
    return out


def phase_tune_serving(torch, smi, live, ckpt_dir: Path, shipped):
    """Phase 38: the port's tuner (``benchmarks/tune_serving.sweep``, as
    ``--dry-run --iters 5``) at B=128·256² bf16 in this process, the counts
    reset just before and read just after: every variant sane; each one's ms
    in turns and the winner printed.  The port's shipped tuning file must
    name this card (name and power limit) and a variant this run found sane;
    the winner is printed beside it, not gated (the runs are noisy).  Then
    the served default (no ``$MDIE_SERVING_TUNING``): its forward vs the f32
    ``CDAN`` at 2x256² and 2x256x384 (phase 5's limits, 2e-2 / 2e-3), and
    ``-p test`` on phase 10's checkpoint through it, its PSNR and SSIM within
    0.5 dB / 0.02 of phase 16's pinned f32-activation run."""
    from multi_degradation_image_enhancement_tpu_torch.benchmarks import tune_serving
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        LAUNCHES_PER_BLOCK,
    )

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    _serving_counts(reset=True)
    results = tune_serving.sweep(BENCH_BATCH, BENCH_SIZE, TUNE_ITERS, dev, 0.25)
    torch.cuda.synchronize()
    launches = _serving_counts()
    sane = [r for r in results if r["sane"] and "ms_per_step" in r]
    for r in results:
        say("tune_serving", f"[{smi}] {tune_serving.label(r)}: "
            + (f"{r['ms_per_step']:.3f} ms/step (turns {r['ms_turns'][0]:.3f}, "
               f"{r['ms_turns'][1]:.3f}), {r['img_per_s']:.1f} img/s, maxdiff "
               f"{r['maxdiff_vs_baseline_variant']:.3e}, sane {r['sane']}"
               if "ms_per_step" in r else f"FAILED {r.get('error')}"))
    best = min(sane, key=lambda r: r["ms_per_step"]) if sane else None
    keys = tune_serving.KEYS
    cfg = json.loads(cdan_fast._TUNING_PATH.read_text())
    prov = cfg["provenance"]["forward_variants"]
    shipped_variant = {k: cfg[k] for k in keys}
    found = [r for r in sane if {k: r[k] for k in keys} == shipped_variant]
    n = len(results)
    per_variant = 1 + 2 * (2 + TUNE_ITERS)  # the sanity step, then 2 turns of warm-up + timed
    want = {"noise_degrade": n * per_variant, "dense_block": 4 * LAUNCHES_PER_BLOCK * n * per_variant,
            "conv3x3_pool": n * per_variant, "conv3x3": 7 * n * per_variant,
            "dense_block_bf16_act": 17 * per_variant * sum(r["db_bf16_act"] for r in results),
            "bilinear_x2_add": 3 * n * per_variant, "cbam_cm": 4 * n * per_variant}
    say("tune_serving", f"launches {launches} (expected {want}); winner "
        f"{tune_serving.label(best) if best else None} "
        f"({best['ms_per_step']:.3f} ms/step); shipped file: {shipped_variant}, tuned on "
        f"{prov.get('device') if isinstance(prov, dict) else prov} "
        f"{prov.get('power_limit') if isinstance(prov, dict) else ''} on "
        f"{prov.get('date_utc') if isinstance(prov, dict) else '-'}")
    require(len(sane) == n, "every serving variant sane")
    require({k: launches[k] for k in want} == want, "the tuner's steps ran the serving kernels")
    require(isinstance(prov, dict) and f"{prov['device']}, {prov['power_limit']}" == smi,
            "the port's tuning file names this card and its power limit")
    require(bool(found), "the port's tuning file names a variant this run found sane")

    g = torch.Generator(device=dev).manual_seed(38)
    live = live.to(dev)
    forward = cdan_fast.build_serving_apply(live, torch.bfloat16, dev)
    for hw in ((BENCH_SIZE, BENCH_SIZE), EVAL_HW):
        x = torch.rand((2, *hw, 3), device=dev, generator=g)
        with torch.inference_mode():
            err = (forward(x) - live(x)).abs()
        say("tune_serving", f"served default forward vs f32 CDAN at 2x{hw[0]}x{hw[1]}: max "
            f"{err.max().item():.3e} (limit 2e-2) mean {err.mean().item():.3e} (limit 2e-3)")
        require(err.max().item() <= 2e-2 and err.mean().item() <= 2e-3,
                "served default forward vs module")
    test = _cli_test(torch, "served_default", ckpt_dir)
    say("tune_serving", f"-p test through the served default: {test['scores']} against the "
        f"pinned f32-activation run's {shipped['scores']}")
    for a, b in (("metric_psnr", 0.5), ("metric_ssim", 0.02)):
        require(abs(shipped["scores"][a] - test["scores"][a]) <= b,
                f"{a}: the served default and the pinned run agree")
    return {"results": results, "launches": launches, "best": best, "shipped": shipped_variant}


def phase_bench(torch, smi, times, cm_ms):
    """Phase 39: ``python -m …_torch.bench`` as a subprocess with
    ``BENCH_BUDGET_S=240`` and the port's own tuning: exactly one JSON line,
    ``value`` > 0, ``device`` and ``power_limit`` this card's, and the tuning
    it reports the tuning file's; its rate beside phase 7's and phase 17's
    (f32 activations)."""
    import os

    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast

    env = dict(os.environ, BENCH_BUDGET_S=str(BENCH_BUDGET))
    env.pop("MDIE_SERVING_TUNING", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench"], capture_output=True, text=True,
                          timeout=BENCH_BUDGET + 60, env=env)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    say("bench", f"rc {proc.returncode} in {seconds:.1f} s; stdout {proc.stdout.strip()}; stderr "
        f"tail {proc.stderr.strip().splitlines()[-3:]}")
    require(proc.returncode == 0 and len(lines) == 1, "the bench prints exactly one line")
    line = json.loads(lines[0])
    forward = cdan_fast.serving_tuning()
    say("bench", f"[{smi}] {line['value']} img/s at B={line['batch']} ({line['timing_method']}, "
        f"{line.get('ms_per_step_cuda_events')} ms/step by CUDA events), tuning "
        f"{ {k: line.get(k) for k in forward} }; beside phase 7's "
        f"{BENCH_BATCH / times['serving_step_ms'] * 1e3:.1f} img/s ({times['serving_step_ms']:.3f} "
        f"ms) and phase 17's {BENCH_BATCH / cm_ms['cm_step_ms'] * 1e3:.1f} img/s, f32 activations")
    require(line["metric"] == "256px_images_per_sec_per_chip_degrade_restore"
            and line["value"] > 0, "the bench measured")
    require(f"{line['device']}, {line['power_limit']}" == smi, "the bench names this card")
    require({k: line.get(k) for k in forward} == forward,
            "the bench reports the port's tuning file")
    return line


def phase_train_throughput(torch, smi, noise_train_ms):
    """Phase 40: ``benchmarks/train_throughput`` rows b16 and b16_fused at
    256x384 (``--iters 2 --chunk 4``) in this process, the growth counts reset
    just before and read just after: both rows without error and with a
    finite last loss; the fused row's growth launches 16 forward and 16
    backward a step (its warm-up chunk and timed chunks), the plain row's
    none; ms a step beside phase 11's CLI step."""
    from multi_degradation_image_enhancement_tpu_torch.benchmarks import train_throughput
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd, growth_layer_fwd,
    )

    out = Path("build") / "chip_smoke_train_tp" / "train_throughput.json"
    out.unlink(missing_ok=True)
    torch.cuda.synchronize()
    growth_layer_fwd.launches = growth_layer_bwd.launches = 0
    rc = train_throughput.main(["--rows", ",".join(TRAIN_TP["rows"]), "--iters",
                                str(TRAIN_TP["iters"]), "--chunk", str(TRAIN_TP["chunk"]),
                                "--json-out", str(out)])
    torch.cuda.synchronize()
    launches = {"growth_train_fwd": growth_layer_fwd.launches,
                "growth_train_bwd": growth_layer_bwd.launches}
    got = json.loads(out.read_text())
    steps = (1 + TRAIN_TP["iters"]) * TRAIN_TP["chunk"]
    for name in TRAIN_TP["rows"]:
        row = got[name]
        say("train_tp", f"[{smi}] {name}: " + (f"{row['step_ms']:.3f} ms/step, "
            f"{row['img_s']:.1f} img/s, last loss {row['last_loss']:.5f}, growth launches "
            f"{row['growth_launches']}" if "error" not in row else f"FAILED {row['error']}")
            + f"; phase 11's CLI step {noise_train_ms:.3f} ms")
        require("error" not in row and math.isfinite(row["last_loss"]), f"{name} trained")
    say("train_tp", f"growth launches {launches} (expected {16 * steps} each, all of the fused "
        f"row)")
    require(rc == 0 and got["b16"]["growth_launches"] == {"fwd": 0, "bwd": 0},
            "the plain row ran no growth kernel")
    require(launches == {"growth_train_fwd": 16 * steps, "growth_train_bwd": 16 * steps},
            "the fused row ran the growth kernels, 16 forward and 16 backward a step")
    return {"launches": launches, "rows": got}


WORKERS = {"nccl_train": worker_nccl_train, "gloo_steps": worker_gloo_steps,
           "router": worker_router, "expert_cli": worker_expert_cli}


def main() -> int:
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--worker":  # a rank of phases 31-33
        WORKERS[sys.argv[2]](torch, Path(sys.argv[3]), *sys.argv[4:])
        return 0
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
    pin_forward()
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
    cm_launches, step_cm, clean = phase_requests_cm(torch)
    shipped, photo = phase_cli_test(torch, engine)
    cm_ms = eval_times(torch, smi, live, shipped, step_cm, clean)
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
        dir_record = phase_dir_config(torch, smi)
    phase_remat(torch, smi)
    phase_train_options(torch, smi)
    phase_nccl_world1(torch, smi)
    phase_gloo_steps(torch, smi)
    phase_expert_parallel(torch, smi, pipe_records["art"])
    phase_host_io(torch, smi, pipe_records, dir_record)
    bf16_act = phase_bf16_act(torch, smi, model, live, Path(engine.model_path))
    phase_lpips_backbones(torch, smi, shipped)
    phase_scan_chunk(torch, smi)
    unpin_forward()
    tuned = phase_tune_serving(torch, smi, live, Path(engine.model_path), shipped)
    phase_bench(torch, smi, times, cm_ms)
    train_tp = phase_train_throughput(torch, smi, noise_train_ms)
    up = phase_upsample(torch, smi)
    cb = phase_cbam(torch, smi)
    dw = phase_dwconv(torch, smi)

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
        "bilinear_x2_add": (*upsample_work([shape for _, shape in UPSAMPLES]), "f32"),
        "cbam_cm": (*cbam_work([(*shape, with_d) for _, shape, with_d in CBAMS])[:2], "f32"),
        "dwconv3x3": (*dwconv_work(DWCONVS), "f32"),
    }
    work["dense_block_bf16_act"] = work["dense_block"]  # the same four blocks, bf16 activations
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
         "replaces": f"{ref}/conv_pool_cm.py:100", "launches": shipped["launches"]["conv3x3_pool"],
         "max_abs_err": conv_err["conv3x3_pool"], "ms": cm_ms["conv3x3_pool"][0],
         "plain_ms": cm_ms["conv3x3_pool"][1], "library_ms": None,
         "module_route_ms": cm_ms["conv3x3_pool_module_ms"]},
        {"name": "conv3x3", "route": "cuda", "source": f"{src}/conv_cm.cu",
         "replaces": f"{ref}/conv_cm.py:49", "launches": cm_launches["conv3x3"],
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
        {"name": "dense_block_bf16_act", "route": "cuda", "source": f"{src}/dense_block.cu",
         "replaces": f"{ref}/dense_block_cm.py:515",  # _kernel2's bf16_act branch
         "launches": bf16_act["launches"], "max_abs_err": bf16_act["max_abs_err"],
         "ms": bf16_act["ms"], "plain_ms": bf16_act["plain_ms"], "library_ms": None,
         "f32_act_ms": bf16_act["f32_act_ms"]},
    ]
    kernels.append({"name": "bilinear_x2_add", "route": "cuda", "source": f"{src}/upsample.cu",
                    "replaces": None,  # port-only: XLA fuses the JAX decoder's resize + add
                    "launches": up["launches"], "max_ulp_gap": up["max_ulp_gap"], "ms": up["ms"],
                    "plain_ms": up["plain_ms"], "library_ms": up["library_ms"]})
    kernels.append({"name": "cbam_cm", "route": "cuda", "source": f"{src}/cbam.cu",
                    "replaces": None,  # port-only: XLA fuses the JAX forward's CBAM + product
                    "launches": cb["launches"], "max_ulp_gap": cb["max_ulp_gap"], "ms": cb["ms"],
                    "plain_ms": cb["plain_ms"], "library_ms": cb["library_ms"]})
    kernels.append({"name": "dwconv3x3", "route": "cuda", "source": f"{src}/dwconv.cu",
                    "replaces": None,  # port-only: the JAX package has no Restormer
                    "launches": dw["launches"], "max_ulp_gap": dw["max_ulp_gap"], "ms": dw["ms"],
                    "plain_ms": dw["plain_ms"], "library_ms": dw["library_ms"]})
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
    # this slice's entry points (phases 38 and 40), the counts reset just before each
    entry = {**{k: tuned["launches"][k] for k in ("noise_degrade", "dense_block", "conv3x3_pool",
                                                 "conv3x3", "dense_block_bf16_act",
                                                 "bilinear_x2_add", "cbam_cm")},
             **train_tp["launches"]}
    for k in kernels:
        if k["name"] in entry:
            k["entry_point_launches"] = entry[k["name"]]
        flops, nbytes, peak = work[k["name"]]
        k["bound_ms"], k["bound_by"] = bound(flops, nbytes, peak)
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.3f} ms"
        if "module_route_ms" in k:
            lib += f", module route {k['module_route_ms']:.3f} ms"
        if "f32_act_ms" in k:
            lib += f", f32-activation kernel {k['f32_act_ms']:.3f} ms"
        say("bounds", f"[{smi}] {k['name']}: {flops / 1e9:.1f} GFLOP ({peak}), {nbytes / 1e9:.3f} GB "
            f"-> bound {k['bound_ms']:.4f} ms by {k['bound_by']}; kernel {k['ms']:.3f} ms "
            f"(roofline share {k['bound_ms'] / k['ms']:.1%}), plain {k['plain_ms']:.3f} ms, "
            f"library {lib}, launches {k['launches']}"
            + (f", entry points {k['entry_point_launches']}" if "entry_point_launches" in k else ""))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
