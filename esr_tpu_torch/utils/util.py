"""Logging setup and directory helpers (port of the parts of
esr_tpu/utils/util.py the eval CLI uses; stdlib only)."""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime

__all__ = ["get_timestamp", "mkdirs", "setup_logger"]


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdirs(paths) -> None:
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        if p:
            os.makedirs(p, exist_ok=True)


def setup_logger(
    logger_name: str,
    root: str | None = None,
    phase: str = "train",
    level=logging.INFO,
    screen: bool = False,
    tofile: bool = True,
) -> logging.Logger:
    lg = logging.getLogger(logger_name)
    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s", datefmt="%y-%m-%d %H:%M:%S"
    )
    lg.setLevel(level)
    lg.handlers.clear()
    if tofile and root:
        os.makedirs(root, exist_ok=True)
        fh = logging.FileHandler(os.path.join(root, f"{phase}_{get_timestamp()}.log"), mode="w")
        fh.setFormatter(formatter)
        lg.addHandler(fh)
    if screen or not (tofile and root):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(formatter)
        lg.addHandler(sh)
    return lg
