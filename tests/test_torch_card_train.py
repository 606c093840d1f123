"""Training at full width on the card: the port's copy of
train_explorable_SR.json (G nf 64 nb 23 gc 32 x4 with Z and CEM, D nf 64 with
BatchNorm, VGG19 conv5_4 loss, B16 x HR 128, bf16).

The train CLI for 6 steps on the SYNTHETIC set with a checkpoint at 3 and
validation on one PNG written by the port's codec; 3 steps then
``--auto_resume`` to 6 equal to the straight run, also with
``async_checkpoint`` and ``use_tb_logger``; the async checkpoint files of
the graphed trainer equal the sync ones; the SR trainer (train_RRDB_PSNR.json)
for 2 steps; launches per G forward (the backward launches none). Each
kernel's autograd Function at the shapes the train step gives it against
the plain version; on one fixed batch and Z, G's gradients through the
kernels against the bf16 and f32 plain paths, in a band shown to fail a
step whose RDB kernel returns its input or whose conv pads with edge pixels.
The step's time is the ``esr_gan_train_b16_hr128`` cell's.
"""

import logging
import math
import statistics

import numpy as np
import pytest
import torch

from esr_tpu_torch.data.lrhr_dataset import SyntheticDataset
from esr_tpu_torch.data.util import save_img
from esr_tpu_torch.models import create_model
from esr_tpu_torch.ops.cuda import autograd as kernel_grads
from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv
from esr_tpu_torch.ops.cuda.kpack_conv import conv3x3_reference
from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_reference
from esr_tpu_torch.ops.fused import upsample2x_conv3x3_reference
from esr_tpu_torch.options import parse
import torch_checks
from torch_card import (B, CEM_TOL, NF, NZ, SCALE, TRAIN_HR, card, conv_band, cuda, gan_grads, gen, grad_band,  # noqa: F401
                        grad_stepper, hr_batches, max_err, per_forward, planted_faults, rdb_faults, rdb_params,
                        release_memory, run_train, train_csv, train_options, train_state)

NAME = "train_gan"


def _max_diff(a: dict, b: dict) -> float:
    """The largest |difference| of G's and D's weights in two training states."""
    return max((a[n]["net"][k].float() - v.float()).abs().max().item() for n in ("G", "D") for k, v in b[n]["net"].items())


def _metrics_diff(rows: list, want: list) -> float:
    return max(abs(float(r[k]) - float(s[k])) / max(abs(float(s[k])), 1e-12)
               for r, s in zip(rows, want) for k in s if k not in ("step", "epoch"))


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The train CLI, 6 steps straight (deterministic cuDNN algorithms: the
    resume tests compare runs); its launches, CSV rows and step-6 state."""
    card()
    tmp = tmp_path_factory.mktemp("train")
    val_dir = tmp / "train_val"
    save_img((SyntheticDataset({"phase": "test", "image_size": 256})._make_image(9) * 255.0).round().astype(np.uint8),
             str(val_dir / "val.png"))
    torch.backends.cudnn.deterministic = True
    try:
        _, launches = run_train(tmp / "straight", train_options(tmp / "straight", NAME, "train_explorable_SR.json",
                                                                val_dir, niter=6))
    finally:
        torch.backends.cudnn.deterministic = False
    return {"tmp": tmp, "val_dir": val_dir, "launches": launches, "rows": train_csv(tmp / "straight", NAME),
            "state": train_state(tmp / "straight", NAME, 6)}


@pytest.mark.cuda
def test_cuda_train_cli_runs_the_flagship(straight):
    """6 GAN steps (one G forward each) and validation at 3 and 6 (one image
    each): 8 x 69 / 4 / 2 launches (the backward launches none); 6 rows of
    finite metrics in train_metrics.csv; the checkpoints at 3, 6 and latest."""
    assert straight["launches"] == per_forward(8)
    rows = straight["rows"]
    assert [int(r["step"]) for r in rows] == list(range(1, 7))
    assert all(math.isfinite(float(v)) for r in rows for k, v in r.items() if k not in ("step", "epoch"))
    models = sorted(p.name for p in (straight["tmp"] / "straight" / "experiments" / NAME / "models").iterdir())
    assert models == ["3_D.pth", "3_G.pth", "6_D.pth", "6_G.pth", "latest_D.pth", "latest_G.pth"]


class BaseLogLines(logging.Handler):
    """The ``base`` log's messages that contain ``word``, caught on the root
    logger (``setup_logger`` replaces the ``base`` logger's own handlers)."""

    def __init__(self, word: str):
        super().__init__(logging.INFO)
        self.word, self.lines = word, []

    def emit(self, record: logging.LogRecord) -> None:
        if record.name == "base" and self.word in record.getMessage():
            self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger().addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)


@pytest.mark.cuda
@pytest.mark.parametrize("writer", ["sync", "async_tb"])
def test_cuda_train_cli_resume_equals_straight(straight, writer):
    """3 steps, then ``--auto_resume`` to 6: the straight run's weights (max
    diff 1e-6) and metrics (1e-5 relative); also with ``async_checkpoint``
    and ``use_tb_logger``, whose log has the CSV's 6 rows and either one line
    a run saying tensorboardX is absent and no event file, or (where it
    imports) the CSV's values at their steps in its event files."""
    root = straight["tmp"] / f"resumed_{writer}"
    opt3 = train_options(root, NAME, "train_explorable_SR.json", straight["val_dir"], niter=3)
    if writer == "async_tb":
        opt3["async_checkpoint"] = True
        opt3["logger"]["use_tb_logger"] = True
    torch.backends.cudnn.deterministic = True
    try:
        with BaseLogLines("tensorboardX") as said:
            run_train(root, opt3)
            run_train(root, dict(opt3, train=dict(opt3["train"], niter=6)), "--auto_resume")
    finally:
        torch.backends.cudnn.deterministic = False
    b = train_state(root, NAME, 6)
    rows = train_csv(root, NAME)
    assert b["iter"] == 6 and len(rows) == 6
    assert _max_diff(straight["state"], b) <= 1e-6 and _metrics_diff(rows, straight["rows"]) <= 1e-5
    if writer == "sync":
        return
    log_dir = root / "experiments" / NAME
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        assert len(said.lines) == 2 and not (log_dir / "tb_logger").exists(), said.lines
    else:
        want = {(k, int(r["step"]), float(np.float32(float(v)))) for r in rows for k, v in r.items()
                if k not in ("step", "epoch", "lr")}
        assert want <= torch_checks.tb_events(log_dir) and not said.lines


CKPT_PENDING_STEPS = 8  # the most graphed GAN steps run while one asynchronous write is pending


@pytest.mark.cuda
def test_cuda_async_checkpoint_of_the_graphed_trainer(straight):
    """``async_checkpoint`` through the graphed GAN trainer at full width: a
    save event (``save(3)`` + ``save_training(1, 3)``) sync, async, and async
    with graphed steps run while the write is pending: the async files equal
    the sync files of the same state tensor for tensor (the weights moved
    since: the snapshot is the state at the call)."""
    root = straight["tmp"] / "ckpt"
    model = create_model(parse(train_options(root, "ckpt", "train_explorable_SR.json", None, niter=100), is_train=True))
    batch = hr_batches(1)[0]
    steps = iter(range(1, 10**6))

    def step():
        model.feed_data(batch)
        model.optimize_parameters(next(steps))
        torch.cuda.synchronize()

    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(3):  # the first captures the step's graph
            step()
        roots = {k: root / k for k in ("sync", "async", "async_steps")}

        def save_into(path, async_):
            model.opt["async_checkpoint"] = async_
            for sub in ("models", "training_state"):
                (path / sub).mkdir(parents=True, exist_ok=True)
                model.opt["path"][sub] = str(path / sub)
            model.save(3)
            model.save_training(1, 3)

        save_into(roots["sync"], False)
        save_into(roots["async"], True)
        model.wait_for_checkpoints()
        save_into(roots["async_steps"], True)
        during = 0  # the steps that began and ended with the write pending
        while during < CKPT_PENDING_STEPS and model.checkpoint_pending():
            step()
            during += model.checkpoint_pending()
        model.wait_for_checkpoints()
    finally:
        torch.backends.cudnn.deterministic = False
    files = {k: torch_checks.checkpoint_files(r) for k, r in roots.items()}
    live_g = model.g_module.state_dict()
    assert sorted(files["sync"]) == ["models/3_D.pth", "models/3_G.pth", "training_state/3.state"]
    assert all(torch_checks.tree_diff(files[k], files["sync"]) is None for k in roots)
    assert during >= 1
    assert any(not torch.equal(v, live_g[k].cpu()) for k, v in files["sync"]["models/3_G.pth"].items())
    del model
    release_memory()


@pytest.mark.cuda
def test_cuda_sr_trainer_runs_the_flagship(straight):
    """The SR (PSNR) trainer, 2 steps: 2 x 69 / 4 / 2 launches, finite l_pix."""
    root = straight["tmp"] / "sr"
    _, launches = run_train(root, train_options(root, "train_sr", "train_RRDB_PSNR.json", None, niter=2))
    rows = train_csv(root, "train_sr")
    assert launches == per_forward(2) and len(rows) == 2 and all(math.isfinite(float(r["l_pix"])) for r in rows)


_RDB_KEYS = tuple(f"{p}{k}" for k in range(1, 6) for p in ("w", "b"))
S = TRAIN_HR // SCALE
# (site, input edge, Cin, Cout, act, 2x2 mode) of each conv of a B16 x HR 128 step's G
TRAIN_CONVS = {"conv_first": (S, 3 + NZ, NF, False, False), "trunk_conv": (S, NF, NF, False, False),
               "upconv1": (S, NF, NF, True, True), "upconv2": (2 * S, NF, NF, True, True),
               "HRconv": (4 * S, NF, NF, True, False), "conv_last": (4 * S, NF, 3, False, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["rdb5c", *TRAIN_CONVS])
def test_cuda_autograd_function_at_the_train_shape(cuda, site):
    """Each kernel's autograd Function (what the train step's G calls) at
    the shape a B16 x HR 128 step gives it, on bf16 inputs and f32 weights as
    the step has them: its output against the f32 plain version in the
    kernels' band (rdb5c: twice the bf16 plain version's error, at
    Kaiming-scale weights where the band is a quarter of what a faulty
    kernel is off by; convs: the same or two bf16 ulps of the largest
    output), one launch counted, and its x, w, b gradients for a seeded
    upstream gradient against the f32 plain version's in the conv band, x's
    in bf16 and the weights' in f32."""
    if site == "rdb5c":
        p = rdb_params(200)
        shape, params, counter = (B, S, S, NF), [p[k] for k in _RDB_KEYS], rdb_conv.LAUNCHES
        fn = lambda x, *wb: kernel_grads.rdb5c_fn(x, dict(zip(_RDB_KEYS, wb)))  # noqa: E731
        plain = lambda x, *wb: rdb5c_reference(x, dict(zip(_RDB_KEYS, wb)))  # noqa: E731
        j = 0
    else:
        j = 1 + list(TRAIN_CONVS).index(site)
        size, cin, cout, act, up = TRAIN_CONVS[site]
        shape = (B, size, size, cin)
        params = [gen((3, 3, cin, cout), 229 + j, math.sqrt(2.0 / (9 * cin))), gen((cout,), 239 + j, 0.01)]
        counter = kpack_conv.LAUNCHES_UP if up else kpack_conv.LAUNCHES
        f, pl = ((kernel_grads.upsample2x_conv3x3_fn, upsample2x_conv3x3_reference) if up
                 else (kernel_grads.conv3x3_fn, conv3x3_reference))
        fn, plain = (lambda x, w, b: f(x, w, b, act)), (lambda x, w, b: pl(x, w, b, act))
    xb = gen(shape, 250 + j).bfloat16()
    before = counter.count
    leaves = [xb.clone().requires_grad_(True)] + [q.clone().requires_grad_(True) for q in params]
    y = fn(*leaves)
    assert counter.count == before + 1
    gy = gen(tuple(y.shape), 270 + j).bfloat16()
    grads = torch.autograd.grad(y, leaves, gy)

    def plain_grads(dtype):
        ls = [xb.to(dtype).detach().requires_grad_(True)] + [q.clone().requires_grad_(True) for q in params]
        out = plain(*ls)
        return out.detach(), torch.autograd.grad(out, ls, gy.to(out.dtype))

    ref, g_ref = plain_grads(torch.float32)
    out_b, g_b = plain_grads(torch.bfloat16)
    tol = 2.0 * max_err(out_b, ref) if site == "rdb5c" else conv_band(ref, max_err(out_b, ref))
    if site == "rdb5c":
        for fault, yf in rdb_faults(xb.float(), dict(zip(_RDB_KEYS, params))).items():
            assert 4.0 * tol <= max_err(yf, ref), fault
    assert y.shape == ref.shape and max_err(y, ref) <= tol
    assert grads[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads[1:])
    for gk, gr, gb in zip(grads, g_ref, g_b):
        assert max_err(gk, gr) <= max(conv_band(gr, max_err(gb, gr)), 1e-30)


@pytest.mark.cuda
def test_cuda_gan_step_gradients_through_the_kernels():
    """One GAN step on a fixed batch and Z with Adam replaced by capture:
    through the kernels 69 / 4 / 2 launches (the forward's; the recompute
    backward launches none); the losses finite on the kernel, bf16 plain and
    f32 plain paths; G's gradients through the kernels against f32 plain
    within twice the bf16 plain path's relative L2 (at least a bf16
    half-ulp) for every tensor but conv_last.bias (a float-noise gradient);
    the step's own fake within CEM_TOL of its LR under H."""
    run = gan_grads()
    assert run.launches == per_forward(1)
    assert all(math.isfinite(float(v)) for m in (run.kernels[0], run.bf16_plain[0], run.f32_plain[0])
               for v in m.values())
    worst, rows_k, rows_b = grad_band(run.names, run.kernels[1], run.bf16_plain[1], run.f32_plain[1])
    assert worst <= 1.0, (worst, statistics.median(rows_k), max(rows_k), statistics.median(rows_b))
    assert max_err(run.model.cem.downsample(run.kernels[2]), run.batch["LR"]) <= CEM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [k for k, (_, _, held) in planted_faults().items() if held])
def test_cuda_gan_step_band_fails_planted_faults(fault):
    """The step-level band on a train step whose kernel inside the autograd
    Functions is a planted fault: an RDB kernel that returns its input, a
    conv that pads with the edge pixels: the worst ratio to the band is
    above 1. (An RDB that skips the image-edge zeroing moves G's gradients
    by less than bf16 rounding does at G's initial weights; the Function
    test at the train shape sees it.)"""
    run = gan_grads()
    attr, stand_in, _ = planted_faults()[fault]
    orig = getattr(kernel_grads, attr)
    setattr(kernel_grads, attr, stand_in)
    try:
        _, g_x, _ = grad_stepper(run.model, run.batch)(run.model.g_module)
    finally:
        setattr(kernel_grads, attr, orig)
    worst, _, _ = grad_band(run.names, g_x, run.bf16_plain[1], run.f32_plain[1])
    assert worst > 1.0, worst
