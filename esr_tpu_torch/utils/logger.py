"""Training logger (port of esr_tpu/utils/logger.py): per-step scalars to the
``base`` logger and to ``train_metrics.csv`` in the log dir (resume-safe: an
existing header is adopted), validation metrics to the logger. The JAX
package's optional tensorboardX output is not ported (no tensorboardX on the
card's machine)."""

from __future__ import annotations

import csv
import logging
import os

__all__ = ["Logger"]


class Logger:
    def __init__(self, opt: dict):
        self.opt = opt
        self.log_dir = opt["path"].get("log") or "."
        os.makedirs(self.log_dir, exist_ok=True)
        self._logger = logging.getLogger("base")
        self._csv_path = os.path.join(self.log_dir, "train_metrics.csv")
        self._csv_keys: list[str] | None = None
        self._warned_dropped = False

    def log_scalars(self, step: int, epoch: int, lr: float, scalars: dict) -> None:
        msg = f"<epoch:{epoch:3d}, iter:{step:8,d}, lr:{lr:.3e}> " + " ".join(
            f"{k}: {float(v):.4e}" for k, v in scalars.items()
        )
        self._logger.info(msg)
        row = {"step": step, "epoch": epoch, "lr": lr}
        row.update({k: float(v) for k, v in scalars.items()})
        if self._csv_keys is None:
            self._csv_keys = self._existing_csv_header() or list(row)
            if not os.path.exists(self._csv_path) or os.path.getsize(self._csv_path) == 0:
                with open(self._csv_path, "w", newline="") as f:
                    csv.DictWriter(f, fieldnames=self._csv_keys).writeheader()
        dropped = set(row) - set(self._csv_keys)
        if dropped and not self._warned_dropped:
            self._warned_dropped = True
            self._logger.warning(
                f"train_metrics.csv resume: existing header lacks new metric columns {sorted(dropped)} — "
                "they will not be recorded in the CSV (start a fresh experiment dir to capture them)")
        with open(self._csv_path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._csv_keys, extrasaction="ignore").writerow(row)

    def _existing_csv_header(self) -> list[str] | None:
        try:
            with open(self._csv_path, newline="") as f:
                return next(csv.reader(f), None) or None
        except OSError:
            return None

    def log_validation(self, step: int, epoch: int, metrics: dict) -> None:
        self._logger.info(f"# Validation <epoch:{epoch:3d}, iter:{step:8,d}> " + " ".join(
            f"{k}: {float(v):.4e}" for k, v in metrics.items()))
