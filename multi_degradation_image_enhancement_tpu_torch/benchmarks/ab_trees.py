"""Two checkouts of the port on one card, in turns: the inference DenseBlock
kernels and the serving step.

    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.ab_trees A B [--rounds 2]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)  # a child process
    args = ap.parse_args(argv)
    if args.one:
        print("AB " + json.dumps(measure(args.a)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    failed = False
    roots = (args.a.resolve(), args.b.resolve())
    for _ in range(args.rounds):
        for root in (*roots, *roots[::-1]):
            # run this file by path, so the child imports the package from ``root`` only
            proc = subprocess.run([sys.executable, __file__, str(root), str(root), "--one"],
                                  capture_output=True, text=True, cwd=root, timeout=900)
            line = next((ln[3:] for ln in proc.stdout.splitlines() if ln.startswith("AB ")), None)
            failed |= line is None
            print(f"{root}: {line or f'failed ({proc.returncode}): {proc.stderr[-2000:]}'}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
