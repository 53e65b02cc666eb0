"""Curve plots (counterpart of
``multi_degradation_image_enhancement_tpu/utils/plotting.py``).

matplotlib is imported lazily, with its headless Agg backend.  Where it is
not installed, each plot prints one line and writes the data it would show
beside the PNG's path instead: ``<stem>.json`` with the x values and the
series.  No number of a run depends on a plot.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Sequence, Tuple


def _pyplot():
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_curves(path: str, curves: Dict[str, Tuple[Sequence[float], Sequence[float]]],
                title: str, xlabel: str, ylabel: str, grid: bool = False) -> str:
    """One figure of ``curves`` (label → (x values, y values)) as a PNG at
    ``path``; without matplotlib the same data as ``<stem>.json``.  Returns
    the path written."""
    plt = _pyplot()
    if plt is None:
        out = os.path.splitext(path)[0] + ".json"
        with open(out, "w", encoding="utf-8") as f:
            json.dump({"title": title, "xlabel": xlabel, "ylabel": ylabel,
                       "curves": {k: {"x": [float(v) for v in xs], "y": [float(v) for v in ys]}
                                  for k, (xs, ys) in curves.items()}}, f, indent=2)
        print(f"[plot] matplotlib is not installed; wrote {out} instead of {os.path.basename(path)}")
        return out
    plt.figure()
    for name, (xs, ys) in curves.items():
        plt.plot(list(xs), list(ys), label=name if len(curves) > 1 else None)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.title(title)
    if len(curves) > 1:
        plt.legend()
    if grid:
        plt.grid(True)
    plt.tight_layout()
    plt.savefig(path, dpi=150 if grid else None)
    plt.close()
    return path


def plot_histograms(path: str, groups: Dict[str, Sequence[float]], bins: int, title: str,
                    xlabel: str, ylabel: str) -> str:
    """Overlaid histograms of ``groups`` (name → values) as a PNG; without
    matplotlib each group's ``numpy.histogram`` (counts and edges) as JSON."""
    import numpy as np

    plt = _pyplot()
    if plt is None:
        out = os.path.splitext(path)[0] + ".json"
        hists = {}
        for name, values in groups.items():
            counts, edges = np.histogram(np.asarray(values, np.float64), bins=bins)
            hists[name] = {"counts": counts.tolist(), "edges": edges.tolist()}
        with open(out, "w", encoding="utf-8") as f:
            json.dump({"title": title, "xlabel": xlabel, "ylabel": ylabel, "histograms": hists},
                      f, indent=2)
        print(f"[plot] matplotlib is not installed; wrote {out} instead of {os.path.basename(path)}")
        return out
    plt.figure()
    for name, values in groups.items():
        plt.hist(values, bins=bins, alpha=0.6, label=name)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.title(title)
    plt.legend()
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path


def _epoch_rows(train_csv: str) -> Tuple[List[int], List[Dict[str, float]]]:
    epochs: List[int] = []
    rows: List[Dict[str, float]] = []
    with open(train_csv, "r", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            return epochs, rows
        has_type = "type" in reader.fieldnames
        for r in reader:
            if has_type and r.get("type") != "epoch":
                continue
            if not r.get("epoch"):
                continue
            parsed = {}
            for k, v in r.items():
                try:
                    parsed[k] = float(v)
                except (TypeError, ValueError):
                    continue
            epochs.append(int(float(r["epoch"])))
            rows.append(parsed)
    return epochs, rows


def plot_losses_from_csv(train_csv: str, out_dir: str) -> None:
    """One plot per ``loss_*`` column of the epoch rows of ``train_csv``,
    plus all of them together (``loss_all``)."""
    epochs, rows = _epoch_rows(train_csv)
    if not epochs:
        return
    os.makedirs(out_dir, exist_ok=True)
    keys = sorted({k for r in rows for k in r if k.startswith("loss_")})
    if not keys:
        return
    series = {k: (epochs, [r.get(k, float("nan")) for r in rows]) for k in keys}
    if "loss_total" in series:
        plot_curves(os.path.join(out_dir, "loss_total.png"), {"loss_total": series["loss_total"]},
                    "loss_total", "Epoch", "loss_total", True)
    for k, curve in series.items():
        if k != "loss_total":
            plot_curves(os.path.join(out_dir, f"{k}.png"), {k: curve}, k, "Epoch", k, True)
    plot_curves(os.path.join(out_dir, "loss_all.png"), series, "Loss curves", "Epoch",
                "Loss curves", True)
