"""Training logger (port of esr_tpu/utils/logger.py): per-step scalars to the
``base`` logger and to ``train_metrics.csv`` in the log dir (resume-safe: an
existing header is adopted), validation metrics to the logger. With
``logger.use_tb_logger`` the scalars also go to tensorboardX event files in
``<log>/tb_logger``, each under its own tag at its step and the validation
metrics under ``val/<name>``, as the JAX package writes them. tensorboardX is
imported only then; where it is not installed the CSV is the record, and the
``base`` log says so once."""

from __future__ import annotations

import csv
import logging
import os

__all__ = ["Logger", "open_tb_writer"]


def open_tb_writer(log_dir: str):
    """A tensorboardX ``SummaryWriter`` on ``<log_dir>/tb_logger``, or None
    (said in the ``base`` log) where tensorboardX is not importable."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        logging.getLogger("base").info(f"logger.use_tb_logger: tensorboardX is not importable ({e}); the scalars "
                                       "go to train_metrics.csv only")
        return None
    return SummaryWriter(os.path.join(log_dir, "tb_logger"))


class Logger:
    def __init__(self, opt: dict):
        self.opt = opt
        self.log_dir = opt["path"].get("log") or "."
        os.makedirs(self.log_dir, exist_ok=True)
        self._logger = logging.getLogger("base")
        self.tb = open_tb_writer(self.log_dir) if (opt.get("logger") or {}).get("use_tb_logger") else None
        self._csv_path = os.path.join(self.log_dir, "train_metrics.csv")
        self._csv_keys: list[str] | None = None
        self._warned_dropped = False

    def log_scalars(self, step: int, epoch: int, lr: float, scalars: dict) -> None:
        msg = f"<epoch:{epoch:3d}, iter:{step:8,d}, lr:{lr:.3e}> " + " ".join(
            f"{k}: {float(v):.4e}" for k, v in scalars.items()
        )
        self._logger.info(msg)
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)
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
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f"val/{k}", float(v), step)

    def close(self) -> None:
        """Flush and close the event files (tensorboardX flushes on its own
        only every two minutes)."""
        if self.tb is not None:
            self.tb.close()
            self.tb = None
