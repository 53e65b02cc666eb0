"""Classifier metrics: F1 variants, severity MAE, threshold tuning, PR/AP
(the port's own copy of
``multi_degradation_image_enhancement_tpu/classification/metrics.py``).

NumPy on the host over collected outputs, the same arithmetic as the JAX
package's module.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

DEFAULT_THRESH = 0.5
EPS = 1e-9


def f1_micro_macro(y_true: np.ndarray, y_pred: np.ndarray) -> Tuple[float, float]:
    tp = (y_true * y_pred).sum()
    fp = ((1 - y_true) * y_pred).sum()
    fn = (y_true * (1 - y_pred)).sum()
    prec = tp / (tp + fp + EPS)
    rec = tp / (tp + fn + EPS)
    f1_micro = 2 * prec * rec / (prec + rec + EPS)

    f1s = []
    for c in range(y_true.shape[1]):
        tpc = (y_true[:, c] * y_pred[:, c]).sum()
        fpc = ((1 - y_true[:, c]) * y_pred[:, c]).sum()
        fnc = (y_true[:, c] * (1 - y_pred[:, c])).sum()
        pre = tpc / (tpc + fpc + EPS)
        re = tpc / (tpc + fnc + EPS)
        f1s.append(2 * pre * re / (pre + re + EPS))
    return float(f1_micro), float(np.mean(f1s))


def per_class_f1(y_true: np.ndarray, y_pred: np.ndarray, classes: List[str]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for i, c in enumerate(classes):
        tp = (y_true[:, i] * y_pred[:, i]).sum()
        fp = ((1 - y_true[:, i]) * y_pred[:, i]).sum()
        fn = (y_true[:, i] * (1 - y_pred[:, i])).sum()
        pre = tp / (tp + fp + EPS)
        re = tp / (tp + fn + EPS)
        out[c] = float(2 * pre * re / (pre + re + EPS))
    return out


def severity_mae(y_true_lbl: np.ndarray, s_true: np.ndarray, s_pred: np.ndarray) -> float:
    mask = y_true_lbl > 0.5
    if mask.sum() == 0:
        return float("nan")
    return float(np.abs(s_true[mask] - s_pred[mask]).mean())


def apply_thresholds(probs: np.ndarray, thresholds: List[float]) -> np.ndarray:
    th = np.array(thresholds, dtype=np.float32).reshape(1, -1)
    return (probs >= th).astype(np.float32)


def compute_pos_weight(train_rows: List[dict], classes: List[str]) -> np.ndarray:
    """neg/pos per class for weighted BCE (reference ``:183-196``)."""
    pos = np.zeros(len(classes), dtype=np.float64)
    neg = np.zeros(len(classes), dtype=np.float64)
    for r in train_rows:
        for i, c in enumerate(classes):
            if r["labels"][c] == 1:
                pos[i] += 1
            else:
                neg[i] += 1
    return (neg / np.maximum(pos, 1.0)).astype(np.float32)


def tune_thresholds_per_class_for_f1(
    probs: np.ndarray, y_true: np.ndarray, classes: List[str], grid: List[float]
) -> Dict:
    """Per-class F1-maximizing grid search on validation outputs."""
    n_classes = y_true.shape[1]
    best_thr = [DEFAULT_THRESH] * n_classes
    best_f1 = [0.0] * n_classes

    for ci in range(n_classes):
        yt = y_true[:, ci]
        if yt.sum() == 0:
            continue
        best_ci_f1, best_ci_thr = -1.0, DEFAULT_THRESH
        for t in grid:
            yp = (probs[:, ci] >= t).astype(np.float32)
            tp = (yt * yp).sum()
            fp = ((1 - yt) * yp).sum()
            fn = (yt * (1 - yp)).sum()
            pre = tp / (tp + fp + EPS)
            re = tp / (tp + fn + EPS)
            f1 = 2 * pre * re / (pre + re + EPS)
            if f1 > best_ci_f1:
                best_ci_f1, best_ci_thr = float(f1), float(t)
        best_thr[ci], best_f1[ci] = best_ci_thr, best_ci_f1

    y_hat = apply_thresholds(probs, best_thr)
    f1_micro, f1_macro = f1_micro_macro(y_true, y_hat)
    return {
        "objective": "maximize per-class F1 on VAL (grid search), then evaluate overall",
        "grid": list(grid),
        "thresholds": {c: float(best_thr[i]) for i, c in enumerate(classes)},
        "best_class_f1_on_val": {c: float(best_f1[i]) for i, c in enumerate(classes)},
        "val_f1_micro": float(f1_micro),
        "val_f1_macro": float(f1_macro),
        "val_f1_by_class": per_class_f1(y_true, y_hat, classes),
    }


def precision_recall_curve_binary(
    y_true: np.ndarray, y_score: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank-based PR curve with the (1,0) anchor point prepended."""
    y_true = y_true.astype(np.int32)
    order = np.argsort(-y_score.astype(np.float64))
    y_sorted = y_true[order]
    tp = np.cumsum(y_sorted)
    fp = np.cumsum(1 - y_sorted)
    eps = 1e-12
    precision = tp / (tp + fp + eps)
    recall = tp / (tp[-1] + eps) if tp.size else np.array([], dtype=np.float64)
    precision = np.concatenate([[1.0], precision])
    recall = np.concatenate([[0.0], recall])
    return precision, recall, y_score[order]


def average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    if precision.size == 0 or recall.size == 0:
        return float("nan")
    return float(np.sum(precision[1:] * np.diff(recall)))
