"""The port's checkpoint writes (``esr_tpu_torch/models/base_model.py``) on
the CPU: ``async_checkpoint: true``, the JAX package's orbax
``AsyncCheckpointer``, copies the state to host memory at the call and
writes it on a background thread. Held here: the files of an asynchronous
save equal a synchronous save's tensor for tensor and hold the state at the
call although a train step updates the weights and Adam moments in place
while the write waits; a process that exits with a write in flight leaves
the whole file; a failed write raises at the wait or at the next save; a
reader of ``save_network``'s file sees the old file or the new one, never
a partial one, in both modes; and under ``train_tp`` on two gloo ranks the
train CLI's asynchronous files equal its synchronous ones. The resume and
preemption paths of the train CLI are in tests/test_torch_train_cli.py.
Tiny sizes: the GAN trainer at nf 8, nb 1, gc 4, HR 32, batch 2.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch import nn

import torch_parallel_workers as W
from torch_checks import checkpoint_files, tree_diff
from esr_tpu_torch.data import SyntheticDataset
from esr_tpu_torch.models import create_model
from esr_tpu_torch.models.base_model import BaseModel
from esr_tpu_torch.options import parse
from esr_tpu_torch.parallel import comm
from esr_tpu_torch.utils import mkdirs

from test_torch_preempt import tp_opt
from test_torch_train_helpers import gan_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0  # the longest a test waits for the writer thread

torch.set_num_threads(1)


def _same(a, b) -> None:
    diff = tree_diff(a, b)
    assert diff is None, diff


def _trainer(tmp_path):
    """The tiny GAN trainer on the CPU and four loader-like batches."""
    opt = parse(gan_opt(str(tmp_path)), is_train=True)
    model = create_model(opt, device="cpu")
    ds = SyntheticDataset({"phase": "train", "n_images": 8, "image_size": 48, "HR_size": 32})
    batches = [{"HR": np.stack([ds[2 * i + j]["HR"] for j in range(2)])} for i in range(4)]
    return model, batches


def _save_into(model, root, async_: bool) -> None:
    """``save(2)`` and ``save_training(1, 2)`` into ``root``'s models and training_state."""
    model.opt["async_checkpoint"] = async_
    model.opt["path"]["models"] = os.path.join(str(root), "models")
    model.opt["path"]["training_state"] = os.path.join(str(root), "training_state")
    mkdirs([model.opt["path"]["models"], model.opt["path"]["training_state"]])
    model.save(2)
    model.save_training(1, 2)


def _gate(monkeypatch, suffix: str):
    """``torch.save`` held at its start for files ending in ``suffix`` until
    the returned ``release`` is set; ``started`` is set when one is held."""
    real, started, release = torch.save, threading.Event(), threading.Event()

    def gated(obj, f, *args, **kwargs):
        if str(f).endswith(suffix):
            started.set()
            assert release.wait(WAIT_S)
        return real(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", gated)
    return started, release


def test_async_files_hold_the_state_at_the_call(tmp_path, monkeypatch):
    """Two steps, a synchronous save, then an asynchronous one whose training
    state write is held until a third step has updated every weight and Adam
    moment in place: the asynchronous files equal the synchronous ones tensor
    for tensor (the state at the call), and differ from the live state."""
    model, batches = _trainer(tmp_path)
    for s in (1, 2):
        model.feed_data(batches[s - 1])
        model.optimize_parameters(s)
    _save_into(model, tmp_path / "sync", async_=False)
    started, release = _gate(monkeypatch, ".state.tmp")
    _save_into(model, tmp_path / "async", async_=True)
    assert started.wait(WAIT_S)
    state_path = tmp_path / "async" / "training_state" / "2.state"
    model.feed_data(batches[2])
    model.optimize_parameters(3)  # the write waits meanwhile
    assert not state_path.exists() and model.checkpoint_pending()
    release.set()
    model.wait_for_checkpoints()
    assert not model.checkpoint_pending()
    sync, async_ = checkpoint_files(tmp_path / "sync"), checkpoint_files(tmp_path / "async")
    assert sorted(sync) == sorted(async_) == ["models/2_D.pth", "models/2_G.pth", "training_state/2.state"]
    _same(async_, sync)
    live = model.g_module.state_dict()
    assert any(not torch.equal(v, live[k]) for k, v in async_["models/2_G.pth"].items())
    assert not any(n.endswith(".tmp") for sub in ("models", "training_state")
                   for n in os.listdir(tmp_path / "async" / sub))
    # the files load back into a trainer: a resumed model holds the state at the call
    model.resume_training(str(state_path))
    _same({k: v.clone() for k, v in model.g_module.state_dict().items()}, sync["models/2_G.pth"])


EXIT_SCRIPT = """
import os, sys, time
import torch
from torch import nn
from esr_tpu_torch.models.base_model import BaseModel

real = torch.save
def slow(obj, f, *args, **kwargs):
    time.sleep(1.0)
    return real(obj, f, *args, **kwargs)
torch.save = slow
torch.manual_seed(0)
model = BaseModel({"async_checkpoint": True, "path": {"models": sys.argv[1]}})
path = model.save_network(nn.Linear(64, 32), "G", 1)
print("on disk at exit:", os.path.exists(path), flush=True)
"""


def test_async_write_in_flight_survives_exit(tmp_path):
    """A script that saves asynchronously and exits without waiting: the
    interpreter's exit drains the writer, and the file is whole."""
    proc = subprocess.run([sys.executable, "-c", EXIT_SCRIPT, str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "on disk at exit: False" in proc.stdout  # the write was still in flight when the script ended
    assert os.listdir(tmp_path) == ["1_G.pth"]
    torch.manual_seed(0)
    _same(torch.load(tmp_path / "1_G.pth", weights_only=True), nn.Linear(64, 32).state_dict())


@pytest.mark.parametrize("seen_at", ["wait", "next_save"])
def test_failed_async_write_raises(tmp_path, monkeypatch, seen_at):
    """A write that fails on the writer thread raises from
    ``wait_for_checkpoints``, or from the next save when nothing waited; it
    leaves no file, not even the temporary one."""
    model = BaseModel({"async_checkpoint": True, "path": {"models": str(tmp_path)}})
    real = torch.save

    def full_disk(obj, f, *args, **kwargs):
        with open(f, "wb") as fh:
            fh.write(b"PK\x03\x04")
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", full_disk)
    model.save_network(nn.Linear(4, 4), "G", 1)  # returns: the failure comes on the writer thread
    monkeypatch.setattr(torch, "save", real)
    with pytest.raises(OSError, match="no space left"):
        if seen_at == "wait":
            model.wait_for_checkpoints()
        else:
            model.save_network(nn.Linear(4, 4), "G", 2)
    assert os.listdir(tmp_path) == []
    model.wait_for_checkpoints()  # reported once: the model saves again after it
    model.save_network(nn.Linear(4, 4), "G", 3)
    model.wait_for_checkpoints()
    assert os.listdir(tmp_path) == ["3_G.pth"]


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_save_network_is_atomic(tmp_path, monkeypatch, async_):
    """While ``save_network`` writes a new ``latest_G.pth``, a reader of the
    path loads the previous file whole; after it, the new one."""
    model = BaseModel({"async_checkpoint": async_, "path": {"models": str(tmp_path)}})
    torch.manual_seed(0)
    net = nn.Linear(16, 16)
    path = model.save_network(net, "G", "latest")
    model.wait_for_checkpoints()
    old = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        net.weight.add_(1.0)
    real, half, release = torch.save, threading.Event(), threading.Event()

    def partial(obj, f, *args, **kwargs):
        with open(f, "wb") as fh:  # half a file at the name being written
            fh.write(b"PK\x03\x04" + bytes(64))
        half.set()
        assert release.wait(WAIT_S)
        return real(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", partial)
    writer = threading.Thread(target=model.save_network, args=(net, "G", "latest"))
    writer.start()
    assert half.wait(WAIT_S)
    _same(torch.load(path, weights_only=True), old)
    release.set()
    writer.join(WAIT_S)
    model.wait_for_checkpoints()
    _same(torch.load(path, weights_only=True), dict(net.state_dict()))
    assert os.listdir(tmp_path) == ["latest_G.pth"]


def test_async_checkpoints_match_sync_on_two_tp_ranks(tmp_path):
    """The train CLI under ``train_tp: 2`` on two gloo ranks (each save
    gathers the channel-sharded trunk and its Adam moments, collectives on
    every rank; rank 0 writes), saving at steps 2 and 4: the files of
    ``async_checkpoint: true`` equal the synchronous run's."""
    root = str(tmp_path / "runs")
    runs = []
    for name, async_ in (("sync", False), ("async", True)):
        opt = tp_opt(root, name)
        opt["logger"]["save_checkpoint_freq"] = 2
        opt["async_checkpoint"] = async_
        runs.append((opt, False, None))
    ranks = comm.spawn(W.preempt_runs, 2, tmp_path / "ranks", args=(runs,), timeout=90.0)
    assert ranks[0] == ranks[1] == [[1, 2, 3, 4]] * 2, ranks
    exp = os.path.join(root, "experiments")
    sync, async_ = checkpoint_files(os.path.join(exp, "sync")), checkpoint_files(os.path.join(exp, "async"))
    assert sorted(sync) == sorted(async_) == ["models/2_G.pth", "models/4_G.pth", "models/latest_G.pth",
                                              "training_state/2.state", "training_state/4.state"]
    _same(async_, sync)
