"""What the card tests share (``tests/test_torch_cuda.py``,
``tests/test_torch_card_*.py``): the ``cuda`` fixture, the launch counters,
seeded inputs and weights, the bands the kernel paths are held to and the
faults that show each band tight, the plain paths (every kernel replaced by
its plain PyTorch version) and the flagship's option files pointed at a
test's directory.

The card's machine has no JAX, so the card tests run there without the
conftest (which sets JAX up for the CPU tests)::

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py tests/test_torch_card_*.py \\
        tests/test_torch_swinir.py tests/test_torch_layernorm.py

Every test skips without an NVIDIA GPU (the kernels have no CPU mode)."""

from __future__ import annotations

import csv
import functools
import gc
import json
import math
import re
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esr_tpu_torch.models.base_model import Adam
from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv
from esr_tpu_torch.ops.cuda.kpack_conv import conv3x3_reference
from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_params_from_module, rdb5c_reference
from esr_tpu_torch.ops.fused import upsample2x_conv3x3_reference

REPO = Path(__file__).resolve().parents[1]

F32_TOL = 1e-4  # f32 kernel vs f32 plain: up to 9 * 256 products summed in another order than cuDNN's (TF32 off)
CEM_TOL = 1e-5  # max |H(out) - lr|: the projection is exact up to f32 rounding
PSNR_MARGIN_DB = 1.0  # the bf16 kernel path may trail the bf16 plain path by this much against f32 plain
# the eval CLI's metrics, batched (or over ranks) against serial: the same kernels per image, the CEM
# matmuls at another batch size; PSNR within 1e-3 dB, SSIM 1e-5, others 1e-3 relative
METRIC_TOL = {"psnr": 1e-3, "z_psnr_mean": 1e-3, "z_psnr_spread": 2e-3, "ssim": 1e-5, "z_ssim_mean": 1e-5}

NF, GC, NB, SCALE, NZ = 64, 32, 23, 4, 1  # the flagship: RRDBNet x4 with one Z channel
B, LR = 16, 128  # the bench shape
TRAIN_HR = 128  # the train crop of train_explorable_SR.json (LR 32 x 32)
NOISE_GRADS = ("conv_last.bias",)  # zero in exact arithmetic: the CEM projection removes a constant shift
GRAD_BAND_FLOOR = 2.0**-8  # a bf16 half-ulp: the least relative L2 band a gradient is held to

# every launch counter: the bf16 and f32 routes of both kernel families, and
# conv_f32_kernel's own (last), which counts each launch of the f32 kernel
ALL_COUNTERS = (rdb_conv.LAUNCHES, rdb_conv.LAUNCHES_F32, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP,
                kpack_conv.LAUNCHES_F32_3X3, kpack_conv.LAUNCHES_F32_2X2, kpack_conv.LAUNCHES_F32)
# launches of conv_f32_kernel that one call of each f32 route makes
F32_KERNEL_LAUNCHES = {rdb_conv.LAUNCHES_F32: 5, kpack_conv.LAUNCHES_F32_3X3: 1, kpack_conv.LAUNCHES_F32_2X2: 1}
# the bf16 kernels the main path runs, and their launches in one flagship forward
COUNTERS = (rdb_conv.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP)
EXPECTED_PER_FORWARD = {"rdb5c": 3 * NB, "conv3x3": 4, "upsample2x_conv3x3": 2}
LAYOUT_COUNTERS = (rdb_conv.LAYOUTS, kpack_conv.LAYOUTS)


def card() -> torch.device:
    """The card, TF32 off for every f32 comparison; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def cuda():
    return card()


@pytest.fixture(scope="session")
def g0_pth(tmp_path_factory):
    """The seed-0 flagship generator (nf 64, nb 23, gc 32, one Z channel), saved."""
    from esr_tpu_torch.models import define_G

    card()
    path = tmp_path_factory.mktemp("g0") / "G.pth"
    opt = {"network_G": {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ}, "scale": SCALE}
    torch.save(define_G(opt, device="cuda", seed=0).state_dict(), path)
    return str(path)


def counts(counters=ALL_COUNTERS) -> list[int]:
    return [c.count for c in counters]


def launched(before: list[int], counter) -> bool:
    """Exactly one call counted since ``before`` (the counts of ALL_COUNTERS),
    on ``counter``, and the launches of conv_f32_kernel that its route makes
    (none for a bf16 route)."""
    want = [int(c is counter) for c in ALL_COUNTERS]
    want[-1] = F32_KERNEL_LAUNCHES.get(counter, 0)
    return [c.count - b for c, b in zip(ALL_COUNTERS, before)] == want


def counted(fn, counters=COUNTERS):
    """``fn()`` with every counter of ``counters`` set to 0 just before:
    (its result, the launches by counter name, read after a synchronise)."""
    for c in counters:
        c.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, {c.name: c.count for c in counters}


def per_forward(n: int, want: dict = EXPECTED_PER_FORWARD) -> dict:
    return {k: v * n for k, v in want.items()}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR in dB with peak 1 (images in [0, 1])."""
    mse = torch.mean((a.float() - b.float()) ** 2).item()
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def gen(shape, seed: int, scale: float = 1.0) -> torch.Tensor:
    """Seeded standard normals times ``scale``, f32 on the card."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()


def rdb_params(seed: int, nf: int = NF, gc: int = GC) -> dict:
    """RDB weights at Kaiming scale (gain sqrt 2), not the generator's x0.1:
    the residual branch 0.2 * x5 then has a std near 0.3 beside x's 1, so a
    band on the block's output sees what the convs compute, not only x."""
    out = {}
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        out[f"w{k}"] = gen((3, 3, cin, cout), seed + k, math.sqrt(2.0 / (9 * cin)))
        out[f"b{k}"] = gen((cout,), seed + 10 + k, 0.01)
    return out


def rdb_faults(x: torch.Tensor, p: dict) -> dict[str, torch.Tensor]:
    """The f32 plain RDB with the faults a band must be able to see."""
    w5 = p["w5"].clone()
    w5[:, :, p["w5"].shape[-1]:] = 0  # conv5 reads x only
    no_rezero = rdb5c_reference(F.pad(x, (0, 0, 5, 5, 5, 5)), p)[:, 5:-5, 5:-5]
    return {"drops x1..x4": rdb5c_reference(x, dict(p, w5=w5)),
            "skips the image-edge zeroing": no_rezero, "returns x": x}


def conv_band(ref: torch.Tensor, plain_err: float) -> float:
    """Tolerance of a bf16 conv kernel against the f32 plain version on the
    same (bf16-rounded) inputs: twice the bf16 plain version's own error, or
    two bf16 ulps (2^-6 relative) of the largest output, whichever is larger.
    A conv has no skip path, so its largest output is its own work."""
    return max(2.0 * plain_err, 2.0**-6 * ref.abs().max().item())


def plain_forward(g, lr: torch.Tensor, z: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """The generator's math on its own weights with every kernel replaced by
    its plain PyTorch version, computing in ``dtype`` (RRDBNet with Z at the
    first layer or at all layers; SRResNet)."""
    from esr_tpu_torch.models.architecture import _up_factors
    from esr_tpu_torch.models.blocks import pixel_shuffle

    x = torch.cat([lr, z if z is not None else lr.new_zeros(lr.shape[:-1] + (NZ,))], -1).to(dtype)

    def conv(m, t):
        return conv3x3_reference(t, m.hwio(), m.bias, m.act)

    fea = conv(g.conv_first, x)
    if not hasattr(g, "RRDB_trunk"):  # SRResNet
        trunk = fea
        for i in range(g.nb):
            blk = getattr(g, f"block{i}")
            trunk = trunk + conv(blk.conv2, F.relu(conv(blk.conv1, trunk)))
        fea = fea + conv(g.trunk_conv, trunk)
        for i, r in enumerate(_up_factors(g.scale)):
            fea = pixel_shuffle(conv(getattr(g, f"upconv{i + 1}"), fea), r)
        return conv(g.conv_last, conv(g.HRconv, fea)).float()
    trunk = fea
    for i, blk in enumerate(g.RRDB_trunk):
        if getattr(g, "all_layers", False):  # the 1x1 latent projection, in dtype
            proj = g.latent_proj[i]
            trunk = F.linear(torch.cat([trunk, x[..., 3:]], -1), proj.weight[:, :, 0, 0].to(dtype), proj.bias.to(dtype))
        out = trunk
        for rdb in (blk.RDB1, blk.RDB2, blk.RDB3):
            out = rdb5c_reference(out, rdb5c_params_from_module(rdb))
        trunk = trunk + 0.2 * out
    fea = fea + conv(g.trunk_conv, trunk)
    for up in (g.upconv1, g.upconv2):
        fea = upsample2x_conv3x3_reference(fea, up.hwio(), up.bias, act=True)
    return conv(g.conv_last, conv(g.HRconv, fea)).float()


def old_layout(state: dict) -> dict:
    """A state dict with the port's keys in the reference's old RRDBNet layout
    (``model.0`` / ``model.1.sub.{i}.RDB{j}.conv{k}.0`` / ``model.1.sub.{nb}``
    / ``model.3`` / ``model.6`` / ``model.8`` / ``model.10``)."""
    nb = len({k.split(".")[1] for k in state if k.startswith("RRDB_trunk.")})
    names = {"conv_first": "model.0", "trunk_conv": f"model.1.sub.{nb}", "upconv1": "model.3",
             "upconv2": "model.6", "HRconv": "model.8", "conv_last": "model.10"}
    out = {}
    for k, v in state.items():
        base, leaf = k.rsplit(".", 1)
        m = re.match(r"RRDB_trunk\.(\d+)\.(.+)$", base)
        out[(f"model.1.sub.{m[1]}.{m[2]}.0" if m else names[base]) + "." + leaf] = v
    return out


def plain_path(g, cem, dtype):
    """The CEM-wrapped plain forward in ``dtype``, as a function of (lr, z)."""
    return lambda lr, z: cem.project(plain_forward(g, lr, z, dtype), lr)


def release_memory() -> None:
    """Free a dropped model's graph pool and cached blocks before the next one."""
    gc.collect()
    torch.cuda.empty_cache()


# -- option files ------------------------------------------------------------------


def flagship_options(tmp: Path, pth: str, name: str, datasets: dict, **extra) -> dict:
    """The port's copy of test_explorable.json (flagship RRDB, nz 1, CEM; bf16
    kernels by default), pointed at ``tmp``, the weights ``pth`` and
    ``datasets``."""
    opt = json.loads((REPO / "esr_tpu_torch" / "options" / "test" / "test_explorable.json").read_text())
    opt.update(name=name, datasets=datasets, **extra)
    opt["path"] = {"root": str(tmp), "pretrain_model_G": pth}
    return opt


def train_options(tmp: Path, name: str, json_name: str, val_dir: Path | None, niter: int, **train) -> dict:
    """The port's copy of ``json_name`` (full width), on the SYNTHETIC train
    set at B16 x HR 128 (32 images: epochs of 2 batches), one val PNG,
    ``niter`` steps, a checkpoint every 3, watchdog off."""
    opt = json.loads((REPO / "esr_tpu_torch" / "options" / "train" / json_name).read_text())
    opt["name"] = name
    opt["datasets"] = {"train": {"name": "synthetic", "mode": "SYNTHETIC", "n_images": 32, "image_size": 160,
                                 "batch_size": B, "HR_size": TRAIN_HR, "use_flip": True, "use_rot": True}}
    if val_dir is not None:
        opt["datasets"]["val"] = {"name": "val", "mode": "LRHR", "dataroot_HR": str(val_dir)}
    opt["path"] = {"root": str(tmp)}
    opt["train"].update(niter=niter, val_freq=3, watchdog=False, **train)
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 3}
    return opt


def run_cli(tmp: Path, opt: dict, *flags: str, counters=COUNTERS):
    """The eval CLI on ``opt`` (written under ``tmp``): (its metrics, launches)."""
    from esr_tpu_torch import test as eval_cli

    path = tmp / f"{opt['name']}.json"
    path.write_text(json.dumps(opt))
    return counted(lambda: eval_cli.main(["-opt", str(path), *flags]), counters)


def run_train(tmp: Path, opt: dict, *flags: str, counters=COUNTERS):
    """The train CLI on ``opt`` (written under ``tmp``): (its result, launches)."""
    from esr_tpu_torch import train as train_cli

    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / f"{opt['name']}_{opt['train']['niter']}.json"
    path.write_text(json.dumps(opt))
    return counted(lambda: train_cli.main(["-opt", str(path), *flags]), counters)


def train_state(tmp: Path, name: str, it: int) -> dict:
    return torch.load(tmp / "experiments" / name / "training_state" / f"{it}.state", map_location="cpu",
                      weights_only=True)


def train_csv(tmp: Path, name: str) -> list[dict]:
    with open(tmp / "experiments" / name / "train_metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


def hr_batches(k: int) -> list[dict]:
    """``k`` train batches of B16 uint8 HR 128 crops of the SYNTHETIC set."""
    from esr_tpu_torch.data.lrhr_dataset import SyntheticDataset

    ds = SyntheticDataset({"phase": "train", "n_images": B * k, "image_size": 160, "HR_size": TRAIN_HR})
    return [{"HR": np.stack([ds[j]["HR"] for j in range(i * B, (i + 1) * B)])} for i in range(k)]


# -- the GAN step's gradient band --------------------------------------------------


class GradCapture(Adam):
    """Stands in for a trainer's Adam: keeps the gradients, changes nothing
    (it counts and stages step scalars as Adam does)."""

    def __init__(self, params):
        super().__init__(params)
        self.grads = None

    def step(self, grads, lr=None, sq_sum=None) -> None:  # noqa: ARG002
        self.grads = [g.float() for g in grads]


class KeepProjected:
    """The CEM with the last image it projected kept: the train step's fake."""

    def __init__(self, cem):
        self.cem, self.fake = cem, None

    def __getattr__(self, name):
        return getattr(self.cem, name)

    def project(self, sr, lr):
        self.fake = self.cem.project(sr, lr)
        return self.fake


def fixed_batch(device) -> dict:
    """One fixed train batch (B16 x HR 128, its LR and Z) on ``device``."""
    from esr_tpu_torch.data.pipeline import make_train_pipeline

    hr_u8 = torch.from_numpy(hr_batches(1)[0]["HR"]).to(device)
    return make_train_pipeline(num_latent_channels=NZ)(hr_u8, torch.Generator().manual_seed(0))


def grad_stepper(model, batch: dict):
    """``grad_step(g_call)``: one GAN step of ``model`` on ``batch`` with G
    called as ``g_call`` and Adam replaced by capture; returns its metrics,
    G's gradients and its projected fake (D's statistics restored after)."""
    from esr_tpu_torch.models.base_model import step_keyed
    from esr_tpu_torch.models.srragan_model import make_gan_train_step

    g = model.g_module

    def grad_step(g_call):
        cap, dcap = GradCapture(g.parameters()), GradCapture(model.d_module.parameters())
        stats = {k: v.clone() for k, v in model.d_module.state_dict().items()}
        kept = KeepProjected(model.cem)
        step = make_gan_train_step(g_call, model.d_module, model.f_module, kept, lambda h, gen_: batch,
                                   model.opt["train"], cap, dcap, model.schedulers["G"],
                                   step_keyed(model.schedulers["D"]))
        metrics = step(None, torch.Generator(), 1)
        model.d_module.load_state_dict(stats)
        return metrics, cap.grads, kept.fake.detach()

    return grad_step


def grad_band(names: list[str], g_k: list, g_b: list, g_f: list) -> tuple[float, list, list]:
    """G's gradients ``g_k`` against the f32 plain path's ``g_f``: the worst
    ratio of a tensor's relative L2 to its band (twice the bf16 plain path's,
    at least ``GRAD_BAND_FLOOR``), and the relative L2s of ``g_k`` and ``g_b``."""
    worst, rows_k, rows_b = 0.0, [], []
    for n, gk, gb, gf in zip(names, g_k, g_b, g_f):
        if n in NOISE_GRADS:
            continue
        rk, rb = rel_l2(gk, gf), rel_l2(gb, gf)
        rows_k.append(rk)
        rows_b.append(rb)
        worst = max(worst, rk / max(2 * rb, GRAD_BAND_FLOOR))
    return worst, rows_k, rows_b


def grad_paths(model, batch: dict) -> dict:
    """One GAN step on ``batch`` through the kernels (counted), the bf16 plain
    path and the f32 plain path on the same weights: {path: (metrics, G's
    gradients, fake)} and the kernel step's launches."""
    g, step = model.g_module, grad_stepper(model, batch)
    out, launches = counted(lambda: step(g))
    return {"kernels": out, "launches": launches,
            "bf16 plain": step(lambda x, zz: plain_forward(g, x, zz, torch.bfloat16)),
            "f32 plain": step(lambda x, zz: plain_forward(g, x, zz, torch.float32))}


@functools.cache
def gan_grads() -> SimpleNamespace:
    """The flagship GAN trainer (train_explorable_SR.json, full width) on one
    fixed batch: its three paths' gradients (:func:`grad_paths`) and the bands
    that the parallel and graphed steps are held to: per G tensor twice the
    bf16 plain path's relative L2 from f32 plain (at least a bf16 half-ulp),
    per metric likewise (absolute for the mean logits). Built once a run."""
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    card()
    root = Path(tempfile.mkdtemp(prefix="gan_grads_"))
    model = create_model(parse(train_options(root, "grads", "train_explorable_SR.json", None, niter=1),
                               is_train=True))
    batch = fixed_batch(model.g_module.conv_first.weight.device)
    paths = grad_paths(model, batch)
    names = [n for n, _ in model.g_module.named_parameters()]
    (m_b, g_b, _), (m_f, g_f, _) = paths["bf16 plain"], paths["f32 plain"]
    _, _, rows_b = grad_band(names, g_b, g_b, g_f)
    bands = {"grads": {n: max(2 * rb, GRAD_BAND_FLOOR) for n, rb in zip([n for n in names if n not in NOISE_GRADS],
                                                                          rows_b)},
             "losses": {k: max(2 * abs(float(m_b[k]) - float(v))
                               / (1.0 if k in ("D_real", "D_fake") else max(abs(float(v)), 1e-12)), GRAD_BAND_FLOOR)
                        for k, v in m_f.items()}}
    return SimpleNamespace(model=model, batch=batch, names=names, bands=bands, **{
        k.replace(" ", "_"): v for k, v in paths.items()})


def planted_faults() -> dict:
    """Stand-ins for the kernels inside the autograd Functions, each
    computing what a faulty kernel would: name -> (attribute of
    ``ops.cuda.autograd``, replacement, whether the G-gradient band must fail
    it). An RDB kernel that skips the image-edge zeroing moves G's gradients
    and fake by less than bf16 rounding does at G's initial weights (its
    residual branch is 0.2 x a 0.1-scaled block), so no step-level band can
    see it; the Function test at the train shape does."""
    from esr_tpu_torch.ops.cuda import autograd as kernel_grads

    conv = kernel_grads._conv_live

    def conv_edge(x, kernel, bias, act, ksize):
        if ksize != 3:
            return conv(x, kernel, bias, act, ksize)
        xp = F.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
        return conv3x3_reference(xp.to(x.dtype), kernel, bias, act)[:, 1:-1, 1:-1].contiguous()

    return {
        "rdb5c kernel returns x": ("_rdb5c_live", lambda x, params: x.clone(), True),
        "rdb5c kernel skips the image-edge zeroing": (
            "_rdb5c_live",
            lambda x, params: rdb5c_reference(F.pad(x, (0, 0, 5, 5, 5, 5)), params)[:, 5:-5, 5:-5].contiguous(),
            False),
        "conv3x3 kernel pads with the edge pixels, not zeros": ("_conv_live", conv_edge, True),
    }


# -- the editor ------------------------------------------------------------------

EXPLORE_LR = 128  # the LR image the editor explores
EXPLORE_BOX = (44, 44, 84, 84)  # a 40 x 40 LR selection: bucket 64, crop 256 HR


class SearchLog:
    """Stands in front of a session's Z optimizer: keeps every search's loss
    trace (each tool click runs one or more searches). ``searching`` is set
    while a search runs: G's calls there are its Z steps, one each (a graph
    replay runs no Python, and the capture's call is none), so a forward hook
    counts only the calls outside (:meth:`hook`); ``rendering`` likewise
    while the session's render forward runs (a graph per image shape too:
    :meth:`count_renders` counts its calls)."""

    def __init__(self, inner):
        self.inner, self.traces, self.searching, self.rendering = inner, [], False, False

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *a, **kw):
        self.searching = True
        try:
            z, losses = self.inner(*a, **kw)
        finally:
            self.searching = False
        self.traces.append(np.asarray(losses))
        return z, losses

    def hook(self, g, forwards: list):
        """Count ``g``'s calls outside the searches and the renders in ``forwards[0]``."""
        def count(*_):
            if not (self.searching or self.rendering):
                forwards[0] += 1

        return g.register_forward_hook(count)

    def count_renders(self, sess, renders: list) -> None:
        """Count the session's render calls (one G call each) in ``renders[0]``."""
        render = sess._render

        def counted_render(lr, z):
            renders[0] += 1
            self.rendering = True
            try:
                return render(lr, z)
            finally:
                self.rendering = False

        sess._render = counted_render


def explore_session(tmp: Path, pth: str):
    """The flagship editor as the explore CLI builds it: G from ``pth``, CEM,
    and a D (``define_D(seed=0)``, nf 64, BatchNorm, trained input 128) from
    its own ``.pth``, on an LR 128 x 128 PNG written by the port's codec."""
    from esr_tpu_torch.data.lrhr_dataset import SyntheticDataset
    from esr_tpu_torch.data.util import save_img
    from esr_tpu_torch.explore import cli as explore_cli
    from esr_tpu_torch.models import define_D

    d_opt = {"network_D": {"nf": NF, "norm_type": "batch"}, "datasets": {"train": {"HR_size": 128}}, "bf16": True}
    d_pth = tmp / "D.pth"
    torch.save(define_D(d_opt, device="cuda", seed=0).state_dict(), d_pth)
    lr_png = tmp / "explore_lr.png"
    img = SyntheticDataset({"phase": "test", "image_size": EXPLORE_LR})._make_image(11)
    save_img((img * 255.0).round().astype(np.uint8), str(lr_png))
    opt = flagship_options(tmp, pth, "explore", {})
    opt["path"]["pretrain_model_D"] = str(d_pth)
    opt_path = tmp / "explore.json"
    opt_path.write_text(json.dumps(opt))
    return explore_cli.build_session_from_opt(str(opt_path), str(lr_png), device="cuda")


def selection_crop(lr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 64 x 64 LR crop of ``EXPLORE_BOX``'s bucket and the box's HR mask in it."""
    from esr_tpu_torch.explore.z_optimizer import bucket_crop

    y, x, size = bucket_crop(EXPLORE_BOX, EXPLORE_LR, EXPLORE_LR, SCALE)
    lr_c = lr[:, y : y + size, x : x + size].contiguous()
    mask = torch.zeros(size * SCALE, size * SCALE, device=lr.device)
    mask[(EXPLORE_BOX[0] - y) * SCALE : (EXPLORE_BOX[2] - y) * SCALE,
         (EXPLORE_BOX[1] - x) * SCALE : (EXPLORE_BOX[3] - x) * SCALE] = 1.0
    return lr_c, mask


@torch.no_grad()
def check_variant_forward(g, want: dict, batch: int = B, residual_as_plain: bool = False) -> None:
    """A generator's CEM-wrapped forward (``make_eval_forward``, its graph) at
    B``batch`` x LR 128, seeded LR and Z: launches ``want``, PSNR against the
    f32 plain path at most PSNR_MARGIN_DB below the bf16 plain path's, and the
    CEM residual within CEM_TOL or, with ``residual_as_plain``, the bf16 plain
    path's own where that is larger (CEM's f32 rounding grows with the
    output's magnitude, which the weights set)."""
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.models import make_eval_forward

    cem = make_cem(CEMConf(scale=SCALE), device="cuda")
    fwd = make_eval_forward(g, cem)
    gen_ = torch.Generator("cuda").manual_seed(5)
    lr = torch.rand(batch, LR, LR, 3, device="cuda", generator=gen_)
    z = torch.rand(batch, LR, LR, NZ, device="cuda", generator=gen_) * 2 - 1
    out, launches = counted(lambda: fwd(lr, z))
    ref32 = plain_path(g, cem, torch.float32)(lr, z)
    p16 = plain_path(g, cem, torch.bfloat16)(lr, z)
    pk, pp = psnr(out, ref32), psnr(p16, ref32)
    res, res_plain = max_err(cem.downsample(out), lr), max_err(cem.downsample(p16), lr)
    assert launches == want
    assert pk >= pp - PSNR_MARGIN_DB, (pk, pp)
    assert res <= (max(CEM_TOL, res_plain) if residual_as_plain else CEM_TOL), (res, res_plain)


# -- profiler traces ---------------------------------------------------------------

GRAPH_KERNELS = ("rdb5c_tc_kernel", "conv_tc_kernel")


def region_kernels(events: list, name: str) -> dict:
    """Kernel events of an ``annotate`` region of a Chrome trace by name
    (matched to the region's launch and graph-launch calls by correlation id)."""
    (region,) = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    t0, t1 = region["ts"], region["ts"] + region["dur"]
    corr = {e["args"]["correlation"] for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
            and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})}
    ks = [e for e in events if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in corr]
    return {k: sum(k in e["name"] for e in ks) for k in GRAPH_KERNELS}


def span_split(events: list, name: str) -> dict:
    """The launch calls of one ``annotate`` region of a Chrome trace (of
    kernels and of CUDA graphs, whose kernels carry the graph launch's
    correlation id), the kernels they started (matched by correlation id)
    and ``dropped``, the region's launch calls whose kernel the trace lacks."""
    (region,) = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    t0, t1 = region["ts"], region["ts"] + region["dur"]
    api = [e for e in events if e.get("ph") == "X" and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1
           and e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launch = {e["args"]["correlation"] for e in api if "LaunchKernel" in e["name"] or "GraphLaunch" in e["name"]}
    corr = {e["args"]["correlation"] for e in api}
    kernels = {e["args"]["correlation"] for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in corr}
    return {"launches": len(launch), "graph_launches": sum("GraphLaunch" in e["name"] for e in api),
            "kernels": len(kernels), "dropped": len(launch - kernels)}


def traced(tmp: Path, name: str, warm, fn) -> tuple[dict, dict]:
    """``fn()`` in an ``annotate`` region of a trace that ``warm()`` opens
    (the first kernels of a trace can go missing from it): its kernel events
    by name and its launch calls (``span_split``)."""
    from esr_tpu_torch.utils.profiler import annotate, trace

    log_dir = tmp / f"trace_{name}"
    with trace(str(log_dir)):
        warm()
        torch.cuda.synchronize()
        with annotate(name):
            fn()
            torch.cuda.synchronize()
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    return region_kernels(events, name), span_split(events, name)
