#!/usr/bin/env python
"""Multi-label degradation classifier: train / tune / test / diagnostics CLI
(counterpart of ``multi_degradation_image_enhancement_tpu/classification/train.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.classification.train \\
        --dataset_root classifier_dataset [--train --tune_thresh --test --diagnostics] \\
        [--synthetic] [--no_pretrained] [--device cpu]

The JAX CLI's flags and stages (all four when none is given):

* ResNet-18 backbone + class and severity heads, f32; loss = pos-weighted
  BCE + 0.5·SmoothL1(β = 1) of sigmoid(severity logits), masked to positive
  labels (denominator max(Σmask, 1); 0 when no label is positive); Adam at
  ``--lr``, BatchNorm in train mode with Flax's semantics
  (``models.norm.BatchNorm2d``).  On the card PyTorch's TF32 defaults stay
  in force (cuDNN convolutions in TF32, matmuls in f32); the log says which;
* early stopping on val F1-micro with ``--patience``; ``best_model.pt`` (a
  ``state_dict``) + ``best_model.pt.json`` (the JAX meta keys),
  ``history.json``, ``per_class_f1_val.json``, the curve plots
  (``utils.plotting``: PNGs, or their JSON without matplotlib) and
  ``training.log`` through a tee of stdout;
* ``--bn_recal_passes``: frozen-weight ``stats_refresh`` sweeps of the train
  split re-estimate the BatchNorm statistics, adopted (checkpoint and meta
  rewritten) only if val F1-micro does not drop;
* ``--tune_thresh``: the per-class threshold grid on VAL →
  ``thresholds_val.json`` beside the checkpoint, where ``run_pipeline
  --classifier <run_dir>/best_model.pt`` finds it; ``--test`` →
  ``summary.json`` (``backend`` is the torch device); ``--diagnostics`` →
  ``diagnostics/{val,test}/``;
* ``--synthetic`` trains on degradations made on the device each step
  (``classification.synthetic``), with no dataset on disk.

The device is the card unless ``--device cpu``; without a card it raises.
Checkpoints are the port's format (:func:`save_checkpoint`); the JAX
package's msgpack files cross over through ``utils.jax_port``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.classification import metrics as M
from multi_degradation_image_enhancement_tpu_torch.classification.data import (
    ClassifierLoader,
    MultiLabelSeverityDataset,
    read_jsonl,
)
from multi_degradation_image_enhancement_tpu_torch.classification.diagnostics import run_diagnostics
from multi_degradation_image_enhancement_tpu_torch.classification.model import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    MultiHeadClassifier,
    init_classifier,
)
from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import (
    load_weights,
    save_weights,
)
from multi_degradation_image_enhancement_tpu_torch.engine.model import resolve_device
from multi_degradation_image_enhancement_tpu_torch.models.norm import BatchNorm2d
from multi_degradation_image_enhancement_tpu_torch.utils.plotting import plot_curves

LAMBDA_SEVERITY = 0.5
HISTORY_KEYS = ("train_loss", "val_loss", "train_f1micro", "val_f1micro",
                "train_f1macro", "val_f1macro", "train_sev_mae", "val_sev_mae")


def save_checkpoint(path: str, model: torch.nn.Module, meta: Dict) -> None:
    save_weights(path, model)
    with open(path + ".json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``path`` into ``model`` strictly; returns the model."""
    return load_weights(path, model)


class TeeLogger:
    """stdout tee into training.log; :meth:`close` restores stdout."""

    def __init__(self, file_path: str):
        self.terminal = sys.stdout
        self.log = open(file_path, "a", encoding="utf-8")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        sys.stdout = self.terminal
        self.log.close()


def losses(cls_logits: torch.Tensor, sev_logits: torch.Tensor, y: torch.Tensor, s: torch.Tensor,
           pos_weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loss_cls, loss_sev, sev_pred)`` (JAX ``_losses``, ``train.py:80-92``)."""
    loss_cls = F.binary_cross_entropy_with_logits(cls_logits, y, pos_weight=pos_weight)
    sev_pred = torch.sigmoid(sev_logits)
    huber = F.smooth_l1_loss(sev_pred, s, reduction="none", beta=1.0)
    mask = (y > 0.5).float()
    loss_sev = (huber * mask).sum() / mask.sum().clamp(min=1.0)  # 0 when no label is positive
    return loss_cls, loss_sev, sev_pred


def train_step(model: MultiHeadClassifier, opt: torch.optim.Optimizer, x, y, s,
               pos_weight) -> Dict[str, torch.Tensor]:
    """One Adam step in train mode (BatchNorm on batch statistics, its
    running statistics updated); returns the batch's losses and outputs."""
    model.train()
    cls_logits, sev_logits = model(x)
    loss_cls, loss_sev, sev_pred = losses(cls_logits, sev_logits, y, s, pos_weight)
    opt.zero_grad(set_to_none=True)
    (loss_cls + LAMBDA_SEVERITY * loss_sev).backward()
    opt.step()
    return {"loss_cls": loss_cls.detach(), "loss_sev": loss_sev.detach(),
            "probs": torch.sigmoid(cls_logits.detach()), "sev_pred": sev_pred.detach()}


@torch.no_grad()
def eval_step(model: MultiHeadClassifier, x, y, s, pos_weight) -> Dict[str, torch.Tensor]:
    model.eval()
    cls_logits, sev_logits = model(x)
    loss_cls, loss_sev, sev_pred = losses(cls_logits, sev_logits, y, s, pos_weight)
    return {"loss_cls": loss_cls, "loss_sev": loss_sev, "probs": torch.sigmoid(cls_logits),
            "sev_pred": sev_pred}


@torch.no_grad()
def refresh_stats(model: MultiHeadClassifier, batches) -> None:
    """Frozen-weight BatchNorm statistics sweeps (JAX ``_refresh``,
    ``train.py:452-458``): each batch normalised by its own statistics,
    which update the running ones."""
    model.eval()
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.stats_refresh = True
    try:
        for x in batches:
            model(x)
    finally:
        for m in norms:
            m.stats_refresh = False


def run_epoch(loader, classes: List[str], thresholds: List[float], model: MultiHeadClassifier,
              pos_weight: torch.Tensor, opt: Optional[torch.optim.Optimizer] = None
              ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """One pass over a split (a train pass when ``opt`` is given); returns
    (metrics, collected host arrays).  Outputs stay on the device until the
    pass ends."""
    tot_cls, tot_sev, n_batches = 0.0, 0.0, 0
    outs: Dict[str, List[torch.Tensor]] = {k: [] for k in ("probs", "y", "s", "sev_pred")}
    all_paths: List[str] = []
    for x, y, s, paths in loader:
        if opt is not None:
            aux = train_step(model, opt, x, y, s, pos_weight)
        else:
            aux = eval_step(model, x, y, s, pos_weight)
        tot_cls = tot_cls + aux["loss_cls"]
        tot_sev = tot_sev + aux["loss_sev"]
        n_batches += 1
        for k, v in (("probs", aux["probs"]), ("y", y), ("s", s), ("sev_pred", aux["sev_pred"])):
            outs[k].append(v)
        all_paths.extend(paths)

    n_c = len(classes)
    host = {k: (torch.cat(v).cpu().numpy() if v else np.zeros((0, n_c), np.float32))
            for k, v in outs.items()}
    tot_cls, tot_sev = float(tot_cls), float(tot_sev)
    y_hat = M.apply_thresholds(host["probs"], thresholds)
    f1_micro, f1_macro = M.f1_micro_macro(host["y"], y_hat)
    nb = max(1, n_batches)
    metrics = {
        "loss": (tot_cls + LAMBDA_SEVERITY * tot_sev) / nb,
        "loss_cls": tot_cls / nb,
        "loss_sev": tot_sev / nb,
        "f1_micro": f1_micro,
        "f1_macro": f1_macro,
        "sev_mae": M.severity_mae(host["y"], host["s"], host["sev_pred"]),
        "f1_by_class": M.per_class_f1(host["y"], y_hat, classes),
    }
    collected = {"probs": host["probs"], "y_true": host["y"], "s_true": host["s"],
                 "s_pred": host["sev_pred"], "paths": all_paths}
    return metrics, collected


def tf32_state() -> str:
    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", type=str, default="classifier_dataset")
    p.add_argument("--run_base", type=str, default="runs_classifier")
    p.add_argument("--run_dir", type=str, default="")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--train", action="store_true")
    p.add_argument("--tune_thresh", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--diagnostics", action="store_true")
    p.add_argument("--th_min", type=float, default=0.05)
    p.add_argument("--th_max", type=float, default=0.95)
    p.add_argument("--th_steps", type=int, default=19)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=6)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--no_normalize", action="store_true")
    p.add_argument("--bn_recal_passes", type=int, default=0,
                   help="post-training BN stats re-estimation passes over the "
                        "train split (adopted only if val F1 does not degrade)")
    p.add_argument("--no_pretrained", action="store_true")
    p.add_argument("--diag_topk", type=int, default=24)
    p.add_argument("--input_hw", type=int, nargs=2, default=[256, 384])
    p.add_argument("--synthetic", action="store_true",
                   help="train on on-device synthesized degradations (no disk dataset)")
    p.add_argument("--synthetic_images", type=int, default=256)
    p.add_argument("--synthetic_variants", type=int, default=2)
    p.add_argument("--clean_root", type=str, default="",
                   help="clean images for --synthetic (procedural if empty)")
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the initial weights, the loaders and the synthetic plans")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.run_base, exist_ok=True)
    run_dir = args.run_dir or os.path.join(
        args.run_base, datetime.now().strftime("run_%Y-%m-%d_%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    log_path = os.path.join(run_dir, "training.log")
    tee = TeeLogger(log_path)
    sys.stdout = tee
    try:
        return _run(args, device, run_dir, log_path)
    finally:
        tee.close()


def _run(args, device: torch.device, run_dir: str, log_path: str) -> Dict:
    dataset_root = args.dataset_root
    print(f"Logging -> {log_path}")
    print("Backend:", device, torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    if device.type == "cuda":
        print("TF32 (PyTorch's defaults, left as they are):", tf32_state())
    print("Dataset root:", os.path.abspath(dataset_root))
    print("Run dir:", os.path.abspath(run_dir))

    if not (args.train or args.tune_thresh or args.test or args.diagnostics):
        args.train = args.tune_thresh = args.test = args.diagnostics = True

    input_hw = tuple(args.input_hw)
    normalize = not args.no_normalize
    if normalize:
        print(f"Using ImageNet normalization: mean={IMAGENET_MEAN} std={IMAGENET_STD}")

    if args.synthetic:
        from multi_degradation_image_enhancement_tpu_torch.classification.synthetic import (
            SyntheticClassifierDataset,
            SyntheticClassifierLoader,
        )
        from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS

        classes = list(DEGRADATIONS)
        print("Classes (synthetic):", classes)

        def mk_loader(split, shuffle, augment):
            n = args.synthetic_images if split == "train" else max(16, args.synthetic_images // 4)
            ds = SyntheticClassifierDataset(
                split=split, clean_root=args.clean_root or None, n_images=n,
                variants_per_image=args.synthetic_variants, input_hw=input_hw, seed=args.seed,
            )
            return SyntheticClassifierLoader(ds, batch_size=args.batch_size, shuffle=shuffle,
                                             augment=augment, normalize=normalize,
                                             seed=args.seed, device=device)
    else:
        with open(os.path.join(dataset_root, "meta", "classes.json"), encoding="utf-8") as f:
            classes = json.load(f)
        print("Classes:", classes)

        def mk_loader(split, shuffle, augment):
            return ClassifierLoader(
                MultiLabelSeverityDataset(dataset_root, split, classes, input_hw),
                batch_size=args.batch_size, shuffle=shuffle, augment=augment,
                normalize=normalize, num_workers=args.num_workers, seed=args.seed, device=device,
            )

    train_loader = mk_loader("train", True, True)
    val_loader = mk_loader("val", False, False)
    test_loader = mk_loader("test", False, False)
    print(f"Dataset sizes: train={len(train_loader.dataset)} | "
          f"val={len(val_loader.dataset)} | test={len(test_loader.dataset)}")

    model = init_classifier(torch.Generator().manual_seed(args.seed), len(classes),
                            pretrained_backbone=not args.no_pretrained).to(device)
    if args.synthetic:
        train_rows = train_loader.dataset.labels_rows()
    else:
        train_rows = read_jsonl(os.path.join(dataset_root, "train", "labels.jsonl"))
    pos_weight_np = M.compute_pos_weight(train_rows, classes)
    pos_weight = torch.from_numpy(pos_weight_np).to(device)
    print("pos_weight:", pos_weight_np.tolist())

    thresholds = [M.DEFAULT_THRESH] * len(classes)
    best_path = os.path.join(run_dir, "best_model.pt")

    if args.train:
        opt = torch.optim.Adam(model.parameters(), lr=args.lr)
        best_score, patience = -1.0, 0
        history: Dict[str, List[float]] = {k: [] for k in HISTORY_KEYS}
        t0 = time.time()
        for epoch in range(1, args.epochs + 1):
            print(f"\n===== EPOCH {epoch}/{args.epochs} =====")
            e0 = time.time()
            tr, _ = run_epoch(train_loader, classes, thresholds, model, pos_weight, opt)
            va, _ = run_epoch(val_loader, classes, thresholds, model, pos_weight)
            print(f"Train loss={tr['loss']:.4f} (cls={tr['loss_cls']:.4f}, sev={tr['loss_sev']:.4f}) | "
                  f"F1micro={tr['f1_micro']:.4f} F1macro={tr['f1_macro']:.4f} | sevMAE={tr['sev_mae']:.4f}")
            print(f"Val   loss={va['loss']:.4f} (cls={va['loss_cls']:.4f}, sev={va['loss_sev']:.4f}) | "
                  f"F1micro={va['f1_micro']:.4f} F1macro={va['f1_macro']:.4f} | sevMAE={va['sev_mae']:.4f}")
            print(f"epoch time: {time.time() - e0:.1f}s")

            with open(os.path.join(run_dir, "per_class_f1_val.json"), "w") as f:
                json.dump(va["f1_by_class"], f, indent=2)
            for split, m in (("train", tr), ("val", va)):
                history[f"{split}_loss"].append(m["loss"])
                history[f"{split}_f1micro"].append(m["f1_micro"])
                history[f"{split}_f1macro"].append(m["f1_macro"])
                history[f"{split}_sev_mae"].append(m["sev_mae"])

            if va["f1_micro"] > best_score:
                best_score = va["f1_micro"]
                patience = 0
                save_checkpoint(best_path, model, {
                    "classes": classes,
                    "default_thresh": M.DEFAULT_THRESH,
                    "pos_weight": pos_weight_np.tolist(),
                    "epoch": epoch,
                    "val_f1_micro": best_score,
                    "normalize": normalize,
                    "imagenet_mean": IMAGENET_MEAN,
                    "imagenet_std": IMAGENET_STD,
                })
                print(f"Best model saved -> {best_path} (best VAL F1micro={best_score:.4f})")
            else:
                patience += 1
                print(f"Early stopping counter: {patience}/{args.patience}")
                if patience >= args.patience:
                    print("\nEARLY STOPPING (based on VAL)")
                    break

        print(f"\nTotal training time: {(time.time() - t0) / 60:.1f} min")
        with open(os.path.join(run_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=2)
        epochs = list(range(1, len(history["train_loss"]) + 1))
        for key, title, ylabel, name in (("loss", "Loss", "loss", "loss_curve.png"),
                                         ("f1micro", "F1 micro", "F1", "f1_micro.png"),
                                         ("f1macro", "F1 macro", "F1", "f1_macro.png"),
                                         ("sev_mae", "Severity MAE", "MAE", "sev_mae.png")):
            plot_curves(os.path.join(run_dir, name),
                        {"train": (epochs, history[f"train_{key}"]),
                         "val": (epochs, history[f"val_{key}"])}, title, "epoch", ylabel)

    # ---- load checkpoint for tune/test/diagnostics ----
    ckpt_path = args.checkpoint or best_path
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"Checkpoint not found: {ckpt_path}")
    print("\n===== LOADING CHECKPOINT =====")
    print("Checkpoint:", os.path.abspath(ckpt_path))
    load_checkpoint(ckpt_path, model)

    tuned_thresholds = list(thresholds)
    meta_path = ckpt_path + ".json"
    ckpt_meta: Dict = {}
    if os.path.exists(meta_path):
        with open(meta_path, encoding="utf-8") as f:
            ckpt_meta = json.load(f)

    if args.bn_recal_passes > 0:
        # The training EMA tracks batch statistics of a moving network, so the
        # best checkpoint's statistics lag its weights; frozen-weight sweeps
        # re-centre them, adopted only if val F1-micro does not drop.
        print(f"\n===== BN RECALIBRATION ({args.bn_recal_passes} passes) =====")
        stock = copy.deepcopy(model.state_dict())
        for _ in range(args.bn_recal_passes):
            refresh_stats(model, (x for x, _y, _s, _p in train_loader))
        recal = copy.deepcopy(model.state_dict())
        model.load_state_dict(stock)
        base_va, _ = run_epoch(val_loader, classes, thresholds, model, pos_weight)
        model.load_state_dict(recal)
        recal_va, _ = run_epoch(val_loader, classes, thresholds, model, pos_weight)
        print(f"VAL F1micro: stock={base_va['f1_micro']:.4f} "
              f"recalibrated={recal_va['f1_micro']:.4f}")
        if recal_va["f1_micro"] >= base_va["f1_micro"]:
            ckpt_meta["bn_recalibration_passes"] = int(args.bn_recal_passes)
            ckpt_meta["val_f1_micro_recalibrated"] = float(recal_va["f1_micro"])
            save_checkpoint(ckpt_path, model, ckpt_meta)
            print(f"Recalibrated stats adopted -> {ckpt_path}")
        else:
            model.load_state_dict(stock)
            print("Recalibrated stats rejected (val F1 degraded); keeping stock stats")

    if args.tune_thresh:
        print("\n===== THRESHOLD TUNING (VAL) =====")
        grid = [float(x) for x in np.linspace(args.th_min, args.th_max, args.th_steps)]
        _, val_out = run_epoch(val_loader, classes, thresholds, model, pos_weight)
        report = M.tune_thresholds_per_class_for_f1(val_out["probs"], val_out["y_true"],
                                                    classes, grid)
        tuned_thresholds = [report["thresholds"][c] for c in classes]
        with open(os.path.join(run_dir, "thresholds_val.json"), "w") as f:
            json.dump(report, f, indent=2)
        print("Tuned thresholds:", report["thresholds"])
        print(f"VAL F1micro (tuned): {report['val_f1_micro']:.4f} | "
              f"VAL F1macro (tuned): {report['val_f1_macro']:.4f}")

    summary: Dict = {}
    if args.test:
        print("\n===== FINAL TEST =====")
        te, _ = run_epoch(test_loader, classes, tuned_thresholds, model, pos_weight)
        print(f"Test  loss={te['loss']:.4f} (cls={te['loss_cls']:.4f}, sev={te['loss_sev']:.4f}) | "
              f"F1micro={te['f1_micro']:.4f} F1macro={te['f1_macro']:.4f} | sevMAE={te['sev_mae']:.4f}")
        with open(os.path.join(run_dir, "per_class_f1_test.json"), "w") as f:
            json.dump(te["f1_by_class"], f, indent=2)
        summary = {
            "run_dir": run_dir,
            "dataset_root": dataset_root,
            "checkpoint_used": ckpt_path,
            "backend": str(device),
            "classes": classes,
            "default_threshold": M.DEFAULT_THRESH,
            "tuned_thresholds_used": {c: float(tuned_thresholds[i]) for i, c in enumerate(classes)},
            "lambda_severity": LAMBDA_SEVERITY,
            "pos_weight": ckpt_meta.get("pos_weight"),
            "best_val_f1_micro_default_thresh": float(ckpt_meta.get("val_f1_micro", -1.0)),
            "best_epoch": int(ckpt_meta.get("epoch", -1)),
            "normalization": {"enabled": normalize, "mean": IMAGENET_MEAN, "std": IMAGENET_STD},
            "test": {k: te[k] for k in ("loss", "loss_cls", "loss_sev", "f1_micro", "f1_macro",
                                        "sev_mae")},
        }
        with open(os.path.join(run_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)

    if args.diagnostics:
        print("\n===== DIAGNOSTICS =====")
        for split_name, loader in (("val", val_loader), ("test", test_loader)):
            _, out = run_epoch(loader, classes, tuned_thresholds, model, pos_weight)
            run_diagnostics(
                dataset_root=dataset_root, run_dir=run_dir, split_name=split_name,
                classes=classes, probs=out["probs"], y_true=out["y_true"],
                rel_paths=out["paths"], tuned_thresholds=tuned_thresholds,
                topk=args.diag_topk,
            )
            print(f"Diagnostics saved for {split_name.upper()}")

    print("\n[OK]")
    return summary


if __name__ == "__main__":
    main()
