"""The port's train CLI (``esr_tpu_torch.train``) on the CPU: a 6-step GAN
run equals 3 steps + ``--auto_resume`` + 3 (weights, optimiser states and
the logged losses bit for bit: the step's random numbers are a function of
(seed, step) and the loader replays its position); SIGTERM finishes the step
and saves; both again with ``async_checkpoint: true``; steps_per_dispatch 2
(chunks of 2 between the print steps) gives the same trajectory; the
zero-batch error; ``train_metrics.csv``; validation and the checkpoints the
eval CLI loads; the SR trainer. Tiny size: nf 8, nb 1, gc 4, HR 32, batch 2.
"""

import csv
import json
import os
import signal

import numpy as np
import pytest
import torch

from esr_tpu_torch import train as ptrain
from esr_tpu_torch.models import create_model
from esr_tpu_torch.options import parse

from test_torch_train_helpers import gan_opt

torch.set_num_threads(1)


def _opt(root, niter=6, **train):
    opt = gan_opt(str(root), niter=niter, val_freq=3, **train)
    opt["datasets"]["train"].update(n_images=5, image_size=40)
    opt["datasets"]["val"] = {"name": "val", "mode": "SYNTHETIC", "n_images": 1, "image_size": 32}
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 3}
    return opt


def _write(root, opt) -> str:
    path = os.path.join(str(root), f"{opt['name']}.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    return path


def _exp(root, name="train_parity"):
    return os.path.join(str(root), "experiments", name)


def _csv(root, name="train_parity"):
    with open(os.path.join(_exp(root, name), "train_metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


def _state(root, label, name="train_parity"):
    return torch.load(os.path.join(_exp(root, name), "training_state", f"{label}.state"), weights_only=True)


def _same_state(a: dict, b: dict):
    assert a["iter"] == b["iter"] and a["epoch"] == b["epoch"]
    for net in ("G", "D"):
        for k, v in a[net]["net"].items():
            assert torch.equal(v, b[net]["net"][k]), (net, k)
        assert a[net]["opt"]["count"] == b[net]["opt"]["count"]
        for x, y in zip(a[net]["opt"]["mu"] + a[net]["opt"]["nu"], b[net]["opt"]["mu"] + b[net]["opt"]["nu"]):
            assert torch.equal(x, y)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Six steps in one run (5 images, batch 2: epochs of 2 batches)."""
    root = tmp_path_factory.mktemp("straight")
    ptrain.main(["-opt", _write(root, _opt(root)), "--device", "cpu"])
    return root


def test_train_cli_writes_checkpoints_logs_and_validates(straight):
    exp = _exp(straight)
    models = sorted(os.listdir(os.path.join(exp, "models")))
    assert models == ["3_D.pth", "3_G.pth", "6_D.pth", "6_G.pth", "latest_D.pth", "latest_G.pth"]
    assert sorted(os.listdir(os.path.join(exp, "training_state"))) == ["3.state", "6.state"]
    rows = _csv(straight)
    assert [int(r["step"]) for r in rows] == list(range(1, 7))
    assert list(rows[0])[:3] == ["step", "epoch", "lr"]
    assert {"l_d", "l_g", "D_real", "D_fake", "l_g_pix", "l_g_fea", "l_g_gan", "l_g_range", "l_g_map",
            "psnr"} <= set(rows[0])
    assert all(np.isfinite(float(r["l_g"])) for r in rows)
    assert [float(r["lr"]) for r in rows][:3] == [1e-4, 5e-5, 5e-5]  # milestone at 2
    assert sorted(os.listdir(os.path.join(exp, "val_images", "0"))) == ["0_3.png", "0_6.png"]  # val PNGs
    assert _state(straight, 6)["epoch"] == 3
    # the checkpoint is the G the eval side loads
    opt = parse(_opt(straight), is_train=False)
    opt["path"]["pretrain_model_G"] = os.path.join(exp, "models", "latest_G.pth")
    model = create_model(opt, device="cpu")
    want = torch.load(os.path.join(exp, "models", "6_G.pth"), weights_only=True)
    assert all(torch.equal(v, want[k]) for k, v in model.g_module.state_dict().items())


def test_train_cli_resume_equals_straight_run(straight, tmp_path):
    """3 steps, then --auto_resume to 6: the same weights, optimiser states
    and logged losses as the straight run."""
    ptrain.main(["-opt", _write(tmp_path, _opt(tmp_path, niter=3)), "--device", "cpu"])
    ptrain.main(["-opt", _write(tmp_path, _opt(tmp_path, niter=6)), "--device", "cpu", "--auto_resume"])
    _same_state(_state(tmp_path, 6), _state(straight, 6))
    assert _csv(tmp_path) == _csv(straight)


def test_train_cli_sigterm_saves_and_resumes(straight, tmp_path, monkeypatch):
    """SIGTERM during step 2 finishes the step, saves latest + the training
    state at iter 2 and returns; --auto_resume then completes the straight
    run's trajectory."""
    from esr_tpu_torch.models.srragan_model import SRRaGANModel

    orig = SRRaGANModel.optimize_parameters

    def optimize(self, step):
        orig(self, step)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(SRRaGANModel, "optimize_parameters", optimize)
    ptrain.main(["-opt", _write(tmp_path, _opt(tmp_path)), "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(_exp(tmp_path), "training_state"))) == ["2.state"]
    assert os.path.exists(os.path.join(_exp(tmp_path), "models", "latest_G.pth"))
    monkeypatch.setattr(SRRaGANModel, "optimize_parameters", orig)
    ptrain.main(["-opt", _write(tmp_path, _opt(tmp_path)), "--device", "cpu", "--auto_resume"])
    _same_state(_state(tmp_path, 6), _state(straight, 6))
    assert signal.getsignal(signal.SIGTERM) is not None


def test_train_cli_async_checkpoint_resume_equals_straight_run(straight, tmp_path):
    """``async_checkpoint: true`` (checkpoints written on a background thread,
    waited for at the end of the run): 3 steps, then --auto_resume to 6, is
    the straight run, and its files are those of a synchronous run."""
    for niter, flags in ((3, []), (6, ["--auto_resume"])):
        opt = _opt(tmp_path, niter=niter)
        opt["async_checkpoint"] = True
        ptrain.main(["-opt", _write(tmp_path, opt), "--device", "cpu", *flags])
    _same_state(_state(tmp_path, 6), _state(straight, 6))
    assert _csv(tmp_path) == _csv(straight)
    for name in ("3_G.pth", "6_D.pth", "latest_G.pth"):
        got, want = (torch.load(os.path.join(_exp(r), "models", name), weights_only=True) for r in (tmp_path, straight))
        assert got.keys() == want.keys() and all(torch.equal(v, want[k]) for k, v in got.items()), name


def test_train_cli_sigterm_saves_and_resumes_async_checkpoint(straight, tmp_path, monkeypatch):
    """The SIGTERM path with ``async_checkpoint: true``: the preemption save
    is on disk when the CLI returns (it waits for the writes), loadable, and
    --auto_resume completes the straight run's trajectory."""
    from esr_tpu_torch.models.srragan_model import SRRaGANModel

    orig = SRRaGANModel.optimize_parameters

    def optimize(self, step):
        orig(self, step)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    opt = _opt(tmp_path)
    opt["async_checkpoint"] = True
    monkeypatch.setattr(SRRaGANModel, "optimize_parameters", optimize)
    ptrain.main(["-opt", _write(tmp_path, opt), "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(_exp(tmp_path), "training_state"))) == ["2.state"]
    assert sorted(os.listdir(os.path.join(_exp(tmp_path), "models"))) == ["latest_D.pth", "latest_G.pth"]
    state = _state(tmp_path, 2)
    assert state["iter"] == 2
    latest = torch.load(os.path.join(_exp(tmp_path), "models", "latest_G.pth"), weights_only=True)
    assert all(torch.equal(v, state["G"]["net"][k]) for k, v in latest.items())
    monkeypatch.setattr(SRRaGANModel, "optimize_parameters", orig)
    ptrain.main(["-opt", _write(tmp_path, opt), "--device", "cpu", "--auto_resume"])
    _same_state(_state(tmp_path, 6), _state(straight, 6))


def test_train_cli_chunked_dispatch_matches_per_step(straight, tmp_path):
    """steps_per_dispatch 2 with a print every 2 steps runs steps 1-2 and 5-6
    as chunks (3 and 4 alone: validation and saves at 3) and the straight
    run's trajectory: the same states, and its metrics at the printed steps."""
    opt = _opt(tmp_path, steps_per_dispatch=2)
    opt["logger"]["print_freq"] = 2
    from esr_tpu_torch.models.srragan_model import SRRaGANModel

    ran = []
    orig = SRRaGANModel.optimize_parameters_chunk

    def chunk(self, first_step, batches):
        ran.append((first_step, len(batches["HR"])))
        orig(self, first_step, batches)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SRRaGANModel, "optimize_parameters_chunk", chunk)
        ptrain.main(["-opt", _write(tmp_path, opt), "--device", "cpu"])
    assert ran == [(1, 2), (5, 2)]
    _same_state(_state(tmp_path, 6), _state(straight, 6))
    assert _csv(tmp_path) == [r for r in _csv(straight) if int(r["step"]) % 2 == 0]


def test_train_cli_zero_batch_loader_errors(tmp_path):
    opt = _opt(tmp_path)
    opt["datasets"]["train"].update(n_images=1, batch_size=2)
    with pytest.raises(ValueError, match="0 batches"):
        ptrain.main(["-opt", _write(tmp_path, opt), "--device", "cpu"])


def test_train_cli_sr_model_two_steps(tmp_path):
    """The SR (PSNR) trainer through the CLI: l_pix and psnr logged, G saved."""
    opt = _opt(tmp_path, niter=2, pixel_weight=1.0)
    opt.update(model="sr", name="sr_cli")
    opt["network_G"]["num_latent_channels"] = 0
    ptrain.main(["-opt", _write(tmp_path, opt), "--device", "cpu"])
    rows = _csv(tmp_path, "sr_cli")
    assert [int(r["step"]) for r in rows] == [1, 2] and {"l_pix", "psnr"} <= set(rows[0])
    assert sorted(_state(tmp_path, 2, "sr_cli")) == ["G", "epoch", "iter"]


def test_train_cli_defaults_to_cuda_and_refuses_parallel_axes(tmp_path, monkeypatch):
    path = _write(tmp_path, _opt(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptrain.main(["-opt", path])
    # the parallel axes need a process group of their ranks (torchrun); in one process 2 shards raise
    for key in ("train_tp", "train_pp", "train_spatial"):
        with pytest.raises(ValueError, match="only 1 ranks are available|only 1 are in the process group"):
            create_model(parse(dict(_opt(tmp_path), **{key: 2}), is_train=True), device="cpu")
