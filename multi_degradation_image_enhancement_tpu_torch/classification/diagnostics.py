"""Classifier diagnostics: PR curves, AP summaries, score histograms and
FP/FN exports (counterpart of
``multi_degradation_image_enhancement_tpu/classification/diagnostics.py``).

  run_dir/diagnostics/{split}/
    pr_curves.png
    ap_pr_summary.json                     (macro/micro AP + per-class)
    score_hists/{class}.png
    errors/{class}/FP/, errors/{class}/FN/ (top-K most-confident errors,
      copied as NNN__pX.XXXX__name.png) + manifest.json with full label
      vectors + cooccurrence_FP.json / cooccurrence_FN.json

The plots go through ``utils.plotting``: without matplotlib each PNG is
replaced by the JSON of what it would show.  Host-side NumPy throughout.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np

from multi_degradation_image_enhancement_tpu_torch.classification.metrics import (
    apply_thresholds,
    average_precision,
    precision_recall_curve_binary,
)
from multi_degradation_image_enhancement_tpu_torch.utils.plotting import (
    plot_curves,
    plot_histograms,
)


def _ensure(p: str) -> None:
    os.makedirs(p, exist_ok=True)


def compute_cooccurrence(
    indices: np.ndarray, y_true: np.ndarray, y_hat: np.ndarray,
    classes: List[str], focus_ci: int,
) -> Dict:
    true_counts = {c: 0 for c in classes}
    pred_counts = {c: 0 for c in classes}
    for idx in indices.tolist():
        for ci, cls in enumerate(classes):
            if ci == focus_ci:
                continue
            if int(y_true[idx, ci]) == 1:
                true_counts[cls] += 1
            if int(y_hat[idx, ci]) == 1:
                pred_counts[cls] += 1
    true_counts.pop(classes[focus_ci], None)
    pred_counts.pop(classes[focus_ci], None)
    return {
        "num_samples": int(len(indices)),
        "true_on_counts": true_counts,
        "pred_on_counts": pred_counts,
    }


def run_diagnostics(
    dataset_root: str,
    run_dir: str,
    split_name: str,
    classes: List[str],
    probs: np.ndarray,
    y_true: np.ndarray,
    rel_paths: List[str],
    tuned_thresholds: List[float],
    topk: int = 24,
) -> None:
    diag_root = os.path.join(run_dir, "diagnostics", split_name)
    _ensure(os.path.join(diag_root, "score_hists"))
    _ensure(os.path.join(diag_root, "errors"))

    y_hat = apply_thresholds(probs, tuned_thresholds)
    ap_by_class: Dict[str, float] = {}
    pr_curves: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    for ci, cls in enumerate(classes):
        yt = y_true[:, ci].astype(np.int32)
        ps = probs[:, ci].astype(np.float64)

        if yt.sum() == 0:
            ap, prec, rec = float("nan"), np.array([1.0]), np.array([0.0])
        else:
            prec, rec, _ = precision_recall_curve_binary(yt, ps)
            ap = average_precision(prec, rec)
        ap_by_class[cls] = float(ap)
        pr_curves[f"{cls} (AP={ap:.3f})"] = (rec, prec)

        plot_histograms(os.path.join(diag_root, "score_hists", f"{cls}.png"),
                        {"positives": ps[yt == 1], "negatives": ps[yt == 0]}, 30,
                        f"{split_name} score distribution: {cls}", "Predicted probability", "Count")

        fp_idx = np.where((y_hat[:, ci] == 1) & (y_true[:, ci] == 0))[0]
        fn_idx = np.where((y_hat[:, ci] == 0) & (y_true[:, ci] == 1))[0]
        fp_take = fp_idx[np.argsort(-ps[fp_idx])][:topk] if fp_idx.size else fp_idx
        fn_take = fn_idx[np.argsort(ps[fn_idx])][:topk] if fn_idx.size else fn_idx

        cls_root = os.path.join(diag_root, "errors", cls)
        _ensure(os.path.join(cls_root, "FP"))
        _ensure(os.path.join(cls_root, "FN"))

        for err_type, take in (("FP", fp_take), ("FN", fn_take)):
            co = compute_cooccurrence(take, y_true, y_hat, classes, focus_ci=ci)
            with open(os.path.join(cls_root, f"cooccurrence_{err_type}.json"), "w") as f:
                json.dump(
                    {
                        "split": split_name,
                        "focus_class": cls,
                        "error_type": err_type,
                        "threshold_used": float(tuned_thresholds[ci]),
                        **co,
                    },
                    f, indent=2,
                )

        manifest = {"class": cls, "threshold_used": float(tuned_thresholds[ci]), "FP": [], "FN": []}

        def copy_samples(idxs: np.ndarray, bucket: str):
            out_dir = os.path.join(cls_root, bucket)
            for j, idx in enumerate(idxs.tolist()):
                rel = rel_paths[idx]
                if not rel:
                    continue
                src = os.path.join(dataset_root, rel)
                if not os.path.exists(src):
                    continue
                dst = os.path.join(out_dir, f"{j:03d}__p{ps[idx]:.4f}__{os.path.basename(rel)}")
                try:
                    shutil.copy2(src, dst)
                except OSError:
                    continue
                manifest[bucket].append(
                    {
                        "rank": int(j),
                        "src_rel": rel,
                        "dst": os.path.relpath(dst, diag_root),
                        "prob_focus_class": float(ps[idx]),
                        "y_true_focus_class": int(y_true[idx, ci]),
                        "y_pred_focus_class": int(y_hat[idx, ci]),
                        "y_true_all": {c: int(y_true[idx, k]) for k, c in enumerate(classes)},
                        "y_pred_all": {c: int(y_hat[idx, k]) for k, c in enumerate(classes)},
                        "prob_all": {c: float(probs[idx, k]) for k, c in enumerate(classes)},
                    }
                )

        copy_samples(fp_take, "FP")
        copy_samples(fn_take, "FN")
        with open(os.path.join(cls_root, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

    plot_curves(os.path.join(diag_root, "pr_curves.png"), pr_curves, "Precision-Recall curves",
                "Recall", "Precision")

    ap_values = [v for v in ap_by_class.values() if np.isfinite(v)]
    yt_flat = y_true.reshape(-1).astype(np.int32)
    ps_flat = probs.reshape(-1).astype(np.float64)
    if yt_flat.sum() > 0:
        p_micro, r_micro, _ = precision_recall_curve_binary(yt_flat, ps_flat)
        micro_ap = average_precision(p_micro, r_micro)
    else:
        micro_ap = float("nan")
    with open(os.path.join(diag_root, "ap_pr_summary.json"), "w") as f:
        json.dump(
            {
                "split": split_name,
                "macro_ap": float(np.mean(ap_values)) if ap_values else float("nan"),
                "micro_ap": float(micro_ap),
                "ap_by_class": ap_by_class,
            },
            f, indent=2,
        )
