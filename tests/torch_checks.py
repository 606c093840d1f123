"""Readers of what the port writes, shared by the CPU tests and the card
tests (``test_torch_card_train.py``): the
checkpoint files of a run, a bit-for-bit comparison of nested tensor trees,
and the records of tensorboardX event files. Imports torch and numpy only
(tensorboardX inside ``tb_events``), so it runs where JAX is absent."""

from __future__ import annotations

import struct
from pathlib import Path

import torch


def tree_diff(a, b, where: str = "") -> str | None:
    """None when ``a`` and ``b`` (nested dicts / lists of tensors and
    scalars) are equal, tensors bit for bit and of one dtype; else the path
    of the first difference."""
    if isinstance(a, torch.Tensor):
        ok = isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
        return None if ok else where or "/"
    if isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            return f"{where} (keys)"
        return next((d for k in a if (d := tree_diff(a[k], b[k], f"{where}/{k}")) is not None), None)
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return f"{where} (length)"
        return next((d for i, (x, y) in enumerate(zip(a, b))
                     if (d := tree_diff(x, y, f"{where}[{i}]")) is not None), None)
    return None if type(a) is type(b) and a == b else where or "/"


def checkpoint_files(root) -> dict:
    """Every checkpoint file under ``root``'s ``models`` and
    ``training_state`` (``"<sub>/<name>"`` -> the object, loaded on the host)."""
    return {f"{sub}/{p.name}": torch.load(p, map_location="cpu", weights_only=True)
            for sub in ("models", "training_state") for p in sorted((Path(root) / sub).iterdir())}


def tb_events(log_dir) -> set:
    """The (tag, step, value) records of every tensorboardX event file under
    ``<log_dir>/tb_logger``, parsed with ``tensorboardX.proto.event_pb2``
    (``tensorboard`` itself imports TensorFlow)."""
    from tensorboardX.proto import event_pb2

    out = set()
    for path in (Path(log_dir) / "tb_logger").glob("events.out.tfevents.*"):
        data, pos = path.read_bytes(), 0
        while pos < len(data):  # TFRecord: u64 length, u32 crc, payload, u32 crc
            (n,) = struct.unpack("<Q", data[pos : pos + 8])
            ev = event_pb2.Event.FromString(data[pos + 12 : pos + 12 + n])
            pos += 12 + n + 4
            out.update((v.tag, ev.step, v.simple_value) for v in ev.summary.value)
    return out
