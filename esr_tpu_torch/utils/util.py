"""Logging setup, directory helpers, seeding and a console progress bar
(port of esr_tpu/utils/util.py)."""

from __future__ import annotations

import logging
import os
import random
import shutil
import sys
import time
from datetime import datetime

import numpy as np
import torch

__all__ = ["ProgressBar", "get_timestamp", "mkdir_and_rename", "mkdirs", "set_random_seed", "setup_logger"]


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdirs(paths) -> None:
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        if p:
            os.makedirs(p, exist_ok=True)


def mkdir_and_rename(path: str) -> None:
    """If ``path`` exists, move it aside with a timestamp suffix; then create
    it (an experiment directory is never overwritten)."""
    if os.path.exists(path):
        new_name = path + "_archived_" + get_timestamp()
        print(f"Path already exists. Rename it to [{new_name}]")
        shutil.move(path, new_name)
    os.makedirs(path, exist_ok=True)


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the train step
    draws from its own per-step generator, ``models.base_model.step_generator``)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


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


class ProgressBar:
    """Minimal console progress bar with a throughput estimate."""

    def __init__(self, task_num: int = 0, bar_width: int = 40):
        self.task_num = task_num
        self.bar_width = bar_width
        self.completed = 0
        self.start_time = time.time()

    def update(self, msg: str = "") -> None:
        self.completed += 1
        fps = self.completed / max(time.time() - self.start_time, 1e-9)
        if self.task_num:
            marks = int(self.bar_width * self.completed / self.task_num)
            bar = ">" * marks + "-" * (self.bar_width - marks)
            sys.stdout.write(f"\r[{bar}] {self.completed}/{self.task_num}, {fps:.1f} it/s {msg}")
        else:
            sys.stdout.write(f"\rcompleted: {self.completed}, {fps:.1f} it/s {msg}")
        sys.stdout.flush()
        if self.task_num and self.completed == self.task_num:
            sys.stdout.write("\n")
