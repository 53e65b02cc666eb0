"""Two checkouts of the port on one card, in turns: the inference DenseBlock
kernels and the serving step, (``--train``) the training growth layers and
the train step, or (``--kernels``) conv1 + pool (#9), the int8 probe GEMM
(#11 int8) and the serving step.

    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.ab_trees A B [--rounds 2]
    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.ab_trees A B --train
    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.ab_trees A B --kernels

``A`` and ``B`` are repository roots (each holding
``multi_degradation_image_enhancement_tpu_torch/``), e.g. a parent commit
unpacked with ``git archive <commit> multi_degradation_image_enhancement_tpu_torch
| tar -x -C build/parent`` and the working tree.  Each measurement runs in a
process of its own with that root first on ``sys.path`` (each root builds its
kernels into its own ``build/torch_kernels/``), in the order A, B, B, A per
round, so both see the same card.  A process times, with CUDA events (mean of
10 after warm-up), ``dense_block`` on each of the four blocks of a
B=128·256² serving step (``init_cdan`` weights, seed 0; bf16 inputs drawn
U(0, 1)) and the serving step itself (``serving.build_pipeline``), and prints
one ``AB {json}`` line; the parent process prints each with its root's label.
With ``--train`` a process times instead the bf16 train step of
``noise_synthetic.json`` (fused DenseBlocks), on the engine ``run.main``
leaves after one epoch of one batch of 16 (as ``chip_smoke.py``'s phases 10
and 11; its run directory under ``build/ab_train/`` of that root), then the
16 growth layers of a B=16·256×384 train step, forward
(``growth_layer_fwd``) and backward (``growth_layer_bwd``) per DenseBlock
(seeded inputs, bf16 weights).  With ``--kernels`` a process times
``conv3x3_pool`` on conv1 of the CM forward at both serving shapes
(B=128·256² and B=16·256×384; ``init_cdan`` weights, seed 0, folded; bf16
inputs drawn U(0, 1)), ``probe_matmul`` on the int8 probe's operands (32 ×
[1536,512]·[512,2048], ``exp_int8_reprobe.make_operands``) and the serving
step (the CM forward at 256²) at B=128·256².
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (block, c_in, side) of the four DenseBlocks at B=128·256².
BLOCKS = (("dense1", 64, 128), ("dense2", 128, 64), ("dense3", 256, 32), ("final_dense", 3, 256))
BATCH = 128
# (block, c_in, (H, W)) of the four DenseBlocks of a B=16·256×384 train step.
TRAIN_BLOCKS = (("dense1", 64, (128, 192)), ("dense2", 128, (64, 96)), ("dense3", 256, (32, 48)),
                ("final_dense", 3, (256, 384)))
TRAIN_BATCH = 16
TRAIN_CONFIG = "multi_degradation_image_enhancement_tpu/config/noise_synthetic.json"


def measure(root: Path) -> dict:
    """The DenseBlock and serving-step times of the package under ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from multi_degradation_image_enhancement_tpu_torch import serving
    from multi_degradation_image_enhancement_tpu_torch.benchmarks import cuda_ms, require_cuda
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        dense_block,
        pack_dense_block,
    )

    require_cuda()
    if not _build.CSRC_DIR.is_relative_to(root.resolve()):
        raise RuntimeError(f"imported the package from {_build.CSRC_DIR}, not from {root}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = init_cdan(torch.Generator().manual_seed(0))
    modules = {"dense1": model.encoder.dense1, "dense2": model.encoder.dense2,
               "dense3": model.encoder.dense3, "final_dense": model.decoder.final_dense}
    gen = torch.Generator(device=dev).manual_seed(4)
    rec = {}
    for name, c, side in BLOCKS:
        pack = pack_dense_block(modules[name], dev)
        x = torch.rand((BATCH, c, side, side), device=dev, generator=gen).to(torch.bfloat16)
        rec[name] = cuda_ms(lambda: dense_block(x, pack), 10)
    rec["four_blocks"] = sum(rec[name] for name, _, _ in BLOCKS)
    step, clean = serving.build_pipeline(BATCH, 256, torch.bfloat16, "cuda")
    step_gen = torch.Generator().manual_seed(1)
    rec["step_ms"] = cuda_ms(lambda: step(clean, step_gen), 10)
    rec["img_s"] = BATCH / rec["step_ms"] * 1e3
    return rec


def measure_train(root: Path) -> dict:
    """The train-step and growth-layer times of the package under ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from multi_degradation_image_enhancement_tpu_torch import run
    from multi_degradation_image_enhancement_tpu_torch.benchmarks import cuda_ms, require_cuda
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd,
        growth_layer_fwd,
    )
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    require_cuda()
    if not _build.CSRC_DIR.is_relative_to(root.resolve()):
        raise RuntimeError(f"imported the package from {_build.CSRC_DIR}, not from {root}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rec = {}

    # The engine as the CLI leaves it: one epoch of one batch, then the step
    # timed on one loader batch.
    work = root / "build" / "ab_train"
    cfg = json.loads(json.dumps(load_config(str(root / TRAIN_CONFIG))))
    cfg["train"].update(n_epoch=1, model_path=str(work / "weights"))
    cfg["train"]["dataset"]["args"]["n_images"] = TRAIN_BATCH
    cfg["logging"]["root_dir"] = str(work / "runs")
    work.mkdir(parents=True, exist_ok=True)
    (work / "config.json").write_text(json.dumps(cfg))
    engine = run.main(load_config(str(work / "config.json"), phase="train"))
    inputs, targets, mask = next(iter(engine.dataloader))
    step_gen = torch.Generator(device=dev).manual_seed(5)
    rec["train_step_ms"] = cuda_ms(
        lambda: engine._train_step(engine.state, inputs, targets, step_gen, mask), 10, 3)
    rec["train_img_s"] = TRAIN_BATCH / rec["train_step_ms"] * 1e3
    del engine, inputs, targets, mask

    gen = torch.Generator(device=dev).manual_seed(12)
    for name, c_in, (h, w) in TRAIN_BLOCKS:
        fwd = bwd = 0.0
        for i in range(4):
            c = c_in + 16 * i
            x = torch.randn((TRAIN_BATCH, c, h, w), device=dev, generator=gen)
            a = torch.rand(c, device=dev, generator=gen) + 0.5
            b = torch.randn(c, device=dev, generator=gen) * 0.1
            w16 = (torch.randn((16, c, 3, 3), device=dev, generator=gen) * 0.1).to(torch.bfloat16)
            bias = torch.randn(16, device=dev, generator=gen) * 0.1
            dg = torch.randn((TRAIN_BATCH, 16, h, w), device=dev, generator=gen)
            fwd += cuda_ms(lambda: growth_layer_fwd(x, a, b, w16, bias), 10)
            bwd += cuda_ms(lambda: growth_layer_bwd(x, dg, a, b, w16), 10)
        rec[f"{name}_fwd"], rec[f"{name}_bwd"] = fwd, bwd
    rec["growth_fwd"] = sum(rec[f"{n}_fwd"] for n, _, _ in TRAIN_BLOCKS)
    rec["growth_bwd"] = sum(rec[f"{n}_bwd"] for n, _, _ in TRAIN_BLOCKS)
    return rec


def measure_kernels(root: Path) -> dict:
    """#9, #11 int8 and the serving step of the package under ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from multi_degradation_image_enhancement_tpu_torch import serving
    from multi_degradation_image_enhancement_tpu_torch.benchmarks import cuda_ms, require_cuda
    from multi_degradation_image_enhancement_tpu_torch.benchmarks.exp_int8_reprobe import (
        make_operands,
    )
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan
    from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import _fold_all
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import (
        conv3x3_pool,
        pack_conv,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_matmul import probe_matmul

    require_cuda()
    if not _build.CSRC_DIR.is_relative_to(root.resolve()):
        raise RuntimeError(f"imported the package from {_build.CSRC_DIR}, not from {root}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pack = pack_conv(*_fold_all(init_cdan(torch.Generator().manual_seed(0)))["conv1"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    rec = {}
    for label, bsz, (h, w) in (("conv1_pool_256x256", BATCH, (256, 256)),
                               ("conv1_pool_256x384", TRAIN_BATCH, (256, 384))):
        x = torch.rand((bsz, 3, h, w), device=dev, generator=gen).to(torch.bfloat16)
        rec[label] = cuda_ms(lambda: conv3x3_pool(x, pack), 20)
        del x
    a, b = make_operands(torch.int8)
    rec["probe_int8"] = cuda_ms(lambda: probe_matmul(a, b), 20)
    del a, b
    step, clean = serving.build_pipeline(BATCH, 256, torch.bfloat16, "cuda")
    step_gen = torch.Generator().manual_seed(1)
    rec["cm_step_ms"] = cuda_ms(lambda: step(clean, step_gen), 10)
    rec["cm_img_s"] = BATCH / rec["cm_step_ms"] * 1e3
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--train", action="store_true",
                    help="time the training growth layers and the train step")
    ap.add_argument("--kernels", action="store_true",
                     help="time #9, #11 int8 and the serving step")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)  # a child process
    args = ap.parse_args(argv)
    if args.train and args.kernels:
        ap.error("--train and --kernels are two modes: pick one")
    mode = ["--train"] * args.train + ["--kernels"] * args.kernels
    if args.one:
        fn = measure_train if args.train else measure_kernels if args.kernels else measure
        print("AB " + json.dumps(fn(args.a)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    failed = False
    roots = (args.a.resolve(), args.b.resolve())
    for _ in range(args.rounds):
        for root in (*roots, *roots[::-1]):
            # run this file by path, so the child imports the package from ``root`` only
            cmd = [sys.executable, __file__, str(root), str(root), "--one"]
            proc = subprocess.run(cmd + mode,
                                  capture_output=True, text=True, cwd=root, timeout=900)
            line = next((ln[3:] for ln in proc.stdout.splitlines() if ln.startswith("AB ")), None)
            failed |= line is None
            print(f"{root}: {line or f'failed ({proc.returncode}): {proc.stderr[-2000:]}'}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
