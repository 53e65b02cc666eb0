"""Experiment logger: run directories with CSV/JSONL rows and a summary
(counterpart of ``multi_degradation_image_enhancement_tpu/utils/logger.py``,
same artifacts and row schemas).

A run directory ``<root_dir>/<name>/<YYYY-MM-DD_HH-MM-SS>`` holds
``train.csv``/``train.jsonl``, ``test.csv``/``test.jsonl``, an incrementally
rewritten ``summary.json`` and a copy of the config.  CSV headers are frozen
from the first row's keys; rows are flushed at once.  The JAX logger's
``generate_plots``, which its engine never calls, is not ported;
``utils.plotting.plot_losses_from_csv`` draws the curves of a ``train.csv``.
"""

from __future__ import annotations

import csv
import json
import os
from datetime import datetime
from typing import Any, Dict, Optional


class ExperimentLogger:
    def __init__(self, config: Dict[str, Any]):
        self.cfg = config.get("logging", {}) or {}
        self.enabled = bool(self.cfg.get("enabled", False))
        self._run_dir: Optional[str] = None
        self._files: Dict[str, Any] = {}
        self._writers: Dict[str, csv.DictWriter] = {}
        self._fieldnames: Dict[str, list] = {}
        self._summary: Dict[str, Any] = {}
        if not self.enabled:
            return

        task_name = str(config.get("name", "run"))
        root_dir = str(self.cfg.get("root_dir", "runs"))
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self._run_dir = os.path.join(root_dir, task_name, stamp)
        os.makedirs(self._run_dir, exist_ok=True)
        if bool(self.cfg.get("save_config_copy", True)):
            with open(os.path.join(self._run_dir, "config.json"), "w", encoding="utf-8") as f:
                json.dump(config, f, indent=2, ensure_ascii=False)
        self._summary = {"task": task_name, "created_at": datetime.now().isoformat(),
                         "run_dir": self._run_dir}
        self._write_summary()

    def run_dir(self) -> Optional[str]:
        return self._run_dir

    def _path(self, name: str) -> str:
        return os.path.join(self._run_dir, name)

    def _append_jsonl(self, kind: str, row: Dict[str, Any]) -> None:
        with open(self._path(f"{kind}.jsonl"), "a", encoding="utf-8") as f:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")

    def _append_csv(self, kind: str, row: Dict[str, Any]) -> None:
        if kind not in self._writers:
            fieldnames = list(row.keys())  # frozen from the first row
            f = open(self._path(f"{kind}.csv"), "a", newline="", encoding="utf-8")
            writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
            if f.tell() == 0:
                writer.writeheader()
            self._files[kind] = f
            self._writers[kind] = writer
            self._fieldnames[kind] = fieldnames
        self._writers[kind].writerow({k: row.get(k, "") for k in self._fieldnames[kind]})
        self._files[kind].flush()

    def _log(self, kind: str, row: Dict[str, Any]) -> None:
        if not self.enabled or self._run_dir is None:
            return
        sink_cfg = self.cfg.get(kind, {}) or {}
        if bool(sink_cfg.get("save_jsonl", True)):
            self._append_jsonl(kind, row)
        if bool(sink_cfg.get("save_csv", True)):
            self._append_csv(kind, row)

    def log_train(self, row: Dict[str, Any]) -> None:
        self._log("train", row)

    def log_test(self, row: Dict[str, Any]) -> None:
        self._log("test", row)

    def set_summary(self, summary: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        self._summary.update(summary)
        self._write_summary()

    def _write_summary(self) -> None:
        if not self.enabled or self._run_dir is None:
            return
        with open(self._path("summary.json"), "w", encoding="utf-8") as f:
            json.dump(self._summary, f, indent=2, ensure_ascii=False)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._writers.clear()
