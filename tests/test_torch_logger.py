"""The port's training logger (``esr_tpu_torch/utils/logger.py``) against the
JAX package's (``esr_tpu/utils/logger.py``) on the CPU: with
``logger.use_tb_logger`` both write tensorboardX event files under
``<log>/tb_logger`` holding the same (tag, step, value) records (each scalar
under its own tag, validation metrics under ``val/<name>``), and the same
``train_metrics.csv``; with tensorboardX unimportable the port writes the
CSV alone and says so once in the ``base`` log. The event files are read
with ``tensorboardX.proto.event_pb2`` (``tensorboard`` itself would pull in
TensorFlow). Values exact (both write the float32 of the same float).
"""

from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np
import pytest

from torch_checks import tb_events

from esr_tpu.utils.logger import Logger as JLogger
from esr_tpu_torch import train as ptrain
from esr_tpu_torch.utils.logger import Logger

SCALARS = [  # (step, epoch, lr, scalars); the last two steps add a column the header lacks
    (1, 0, 1e-4, {"l_g": 0.25, "l_d": 0.75, "psnr": 10.5}),
    (2, 0, 1e-4, {"l_g": 0.125, "l_d": 0.5, "psnr": 11.25}),
    (3, 1, 5e-5, {"l_g": 0.0625, "l_d": 0.375, "psnr": 12.0, "extra": 1.5}),
    (4, 1, 5e-5, {"l_g": np.float32(0.1), "l_d": np.float64(0.2), "psnr": 12.5, "extra": 2.5}),
]
VALIDATION = [(2, 0, {"psnr": 20.5, "ssim": 0.75}), (4, 1, {"psnr": 21.25, "ssim": 0.8})]


def drive(logger) -> None:
    for step, epoch, lr, scalars in SCALARS:
        logger.log_scalars(step, epoch, lr, scalars)
        for s, e, metrics in VALIDATION:
            if s == step:
                logger.log_validation(s, e, metrics)


def opt_for(log_dir: str, use_tb: bool = True) -> dict:
    return {"path": {"log": log_dir}, "logger": {"use_tb_logger": use_tb}}


def test_event_files_match_jax(tmp_path):
    jlog = JLogger(opt_for(str(tmp_path / "jax")))
    plog = Logger(opt_for(str(tmp_path / "port")))
    assert jlog.tb is not None and plog.tb is not None
    drive(jlog)
    drive(plog)
    jlog.tb.close()  # the JAX logger has no close; its writer flushes every two minutes
    plog.close()
    want = tb_events(str(tmp_path / "jax"))
    assert len(want) == sum(len(s) for *_, s in SCALARS) + sum(len(m) for *_, m in VALIDATION)
    assert {t for t, _, _ in want} == {"l_g", "l_d", "psnr", "extra", "val/psnr", "val/ssim"}
    assert tb_events(str(tmp_path / "port")) == want
    with open(tmp_path / "jax" / "train_metrics.csv") as a, open(tmp_path / "port" / "train_metrics.csv") as b:
        assert a.read() == b.read()


def test_without_tensorboardx_the_csv_alone_and_one_line(tmp_path, monkeypatch, caplog):
    """tensorboardX made unimportable: the same CSV as with it, no event
    files, and one line in the ``base`` log saying why."""
    with_tb = Logger(opt_for(str(tmp_path / "with")))
    drive(with_tb)
    with_tb.close()
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
    with caplog.at_level(logging.INFO, logger="base"):
        plog = Logger(opt_for(str(tmp_path / "without")))
        drive(plog)
        plog.close()
    assert plog.tb is None
    said = [r.getMessage() for r in caplog.records if "tensorboardX" in r.getMessage()]
    assert len(said) == 1 and "train_metrics.csv only" in said[0], said
    assert not os.path.exists(tmp_path / "without" / "tb_logger")
    with open(tmp_path / "with" / "train_metrics.csv") as a, open(tmp_path / "without" / "train_metrics.csv") as b:
        assert a.read() == b.read()
    # use_tb_logger off: no import attempted, nothing said
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="base"):
        Logger(opt_for(str(tmp_path / "off"), use_tb=False))
    assert not [r for r in caplog.records if "tensorboardX" in r.getMessage()]


def test_train_cli_event_file_holds_the_csv_rows(tmp_path):
    """The train CLI with ``use_tb_logger``: the event file holds every CSV
    value at its step under its column's tag (lr and epoch are CSV-only, as
    in the JAX package), and the validation PSNR under ``val/psnr``."""
    opt = {
        "name": "tb", "model": "sr", "scale": 4, "bf16": False,
        "datasets": {"train": {"name": "syn", "mode": "SYNTHETIC", "n_images": 4, "image_size": 48, "batch_size": 2,
                               "HR_size": 32},
                     "val": {"name": "val", "mode": "SYNTHETIC", "n_images": 1, "image_size": 32}},
        "path": {"root": str(tmp_path)},
        "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 0},
        "train": {"lr_G": 1e-4, "manual_seed": 0, "watchdog": False, "pixel_weight": 1.0, "niter": 2, "val_freq": 2},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2, "use_tb_logger": True},
    }
    path = tmp_path / "tb.json"
    path.write_text(json.dumps(opt))
    ptrain.main(["-opt", str(path), "--device", "cpu"])
    log_dir = tmp_path / "experiments" / "tb"
    import csv

    with open(log_dir / "train_metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    want = {(k, int(r["step"]), float(np.float32(float(v)))) for r in rows for k, v in r.items()
            if k not in ("step", "epoch", "lr")}
    got = tb_events(str(log_dir))
    assert len(rows) == 2 and want <= got
    assert {t for t, _, _ in got - want} == {"val/psnr"}
