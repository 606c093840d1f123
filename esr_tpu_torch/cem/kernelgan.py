"""Blind-SR downsampling-kernel estimation, KernelGAN-style (port of
esr_tpu/cem/kernelgan.py).

The kernel is estimated from the LR image itself and handed to the
``opt['kernel']`` -> CEM path:

- **G is a deep linear conv net** (no bias, no nonlinearity, VALID convs)
  ending in an s-stride subsample, so what it learns is one stationary
  downsampling kernel: its impulse response (:func:`effective_kernel`).
- **D is a small fully-convolutional patch discriminator** that tells real
  LR crops from G-downscaled larger crops (LSGAN loss).
- **Kernel regularizers** on the impulse response: sum to 1, boundary
  energy, centre of mass, optional sparsity.

The convs are ``F.conv2d`` in full f32 (TF32 off inside G's and D's
forwards and the step's backward, whatever the caller's cuDNN setting), so
the impulse response equals G to f32 rounding. Two deliberate divergences from the JAX package: the random
crops come from a CPU ``torch.Generator`` seeded by ``conf.seed`` (JAX draws
them with ``jax.random`` inside its scan), and the weights are seeded torch
draws of flax's LeCun-normal init. The step takes its crops as arguments
(:func:`make_kernelgan_step`), so a caller can feed it JAX's. The loop
reads its metrics from the device once per chunk of 100 iterations, where
``progress`` is called; the iterations between do not wait on the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from esr_tpu_torch.device import full_f32, resolve_device
from esr_tpu_torch.models.base_model import Adam
from esr_tpu_torch.models.losses import jax_abs

__all__ = [
    "KernelGANConf",
    "LinearKernelG",
    "PatchD",
    "conf_for_image",
    "effective_kernel",
    "estimate_kernel",
    "make_kernelgan_step",
    "make_override_step",
]

CHUNK = 100  # iterations between two reads of the metrics (and progress calls)


@dataclasses.dataclass(frozen=True)
class KernelGANConf:
    scale: int = 4
    g_kernels: tuple = (9, 7, 5, 3, 1, 1)  # support = sum(k-1)+1 = 21
    g_channels: int = 64
    d_kernels: tuple = (7, 1, 1, 1, 1)
    d_channels: int = 64
    g_input: int = 64  # G crop (LR px); D patches are _fake_size(conf) px
    lr_g: float = 2e-3
    lr_d: float = 2e-3
    iters: int = 2000
    # regularizer weights (the JAX package's reconstruction)
    w_sum2one: float = 0.5
    w_boundaries: float = 0.5
    w_centralized: float = 1.0
    w_sparse: float = 0.0
    seed: int = 0


def _lecun_normal(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """flax's default conv init: truncated normal at +-2 std, variance
    1 / fan_in after the truncation (OIHW ``shape``)."""
    fan_in = shape[1] * shape[2] * shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std, generator=generator)


class _ConvStack(nn.Module):
    """VALID convs ``conv{i}`` (OIHW weights) on an NHWC single-channel input."""

    def __init__(self, kernels: tuple, channels: int, bias: bool, generator: torch.Generator):
        super().__init__()
        cin = 1
        for i, k in enumerate(kernels):
            cout = 1 if i == len(kernels) - 1 else channels
            conv = nn.Conv2d(cin, cout, k, bias=bias)
            with torch.no_grad():
                conv.weight.copy_(_lecun_normal(tuple(conv.weight.shape), generator))
                if bias:
                    conv.bias.zero_()
            self.add_module(f"conv{i}", conv)
            cin = cout
        self.n = len(kernels)

    def convs(self) -> list[nn.Conv2d]:
        return [getattr(self, f"conv{i}") for i in range(self.n)]


class LinearKernelG(_ConvStack):
    """Deep linear generator: stride-1 bias-free VALID convs, then the ``::s``
    subsample. Linearity makes G one stationary kernel; VALID convs leave no
    padding border for D to key on. NHWC (N, H, W, 1) -> (N, h, w, 1)."""

    def __init__(self, conf: KernelGANConf, seed: int = 0):
        super().__init__(conf.g_kernels, conf.g_channels, False, torch.Generator().manual_seed(seed))
        self.scale = conf.scale

    def forward(self, x: torch.Tensor, stride: bool = True) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        with full_f32():
            for conv in self.convs():
                x = F.conv2d(x, conv.weight)
        if stride:
            x = x[:, :, :: self.scale, :: self.scale]
        return x.permute(0, 2, 3, 1)


class PatchD(_ConvStack):
    """Fully-convolutional patch discriminator -> a per-pixel logit map."""

    def __init__(self, conf: KernelGANConf, seed: int = 1):
        super().__init__(conf.d_kernels, conf.d_channels, True, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        convs = self.convs()
        with full_f32():
            for i, conv in enumerate(convs):
                x = F.conv2d(x, conv.weight, conv.bias)
                if i < len(convs) - 1:
                    x = F.leaky_relu(x, 0.2)
        return x.permute(0, 2, 3, 1)


def _support(conf: KernelGANConf) -> int:
    return sum(k - 1 for k in conf.g_kernels) + 1


def _d_receptive(conf: KernelGANConf) -> int:
    return sum(k - 1 for k in conf.d_kernels) + 1


def _fake_size(conf: KernelGANConf) -> int:
    """LR patch size G makes from a ``g_input`` crop: the VALID convs shrink
    it by support - 1, then ``::s`` keeps ceil(L / s). Real crops are drawn
    at this size, so D compares equal supports at any scale."""
    flat = conf.g_input - _support(conf) + 1
    return -(-flat // conf.scale)


def effective_kernel(g: LinearKernelG, conf: KernelGANConf) -> torch.Tensor:
    """G's impulse response (support, support) in correlation convention:
    ``G(x, stride=False)[i] == sum_t k[t] x[i + t]`` over VALID windows. A
    centred delta probe returns the flipped kernel under cross-correlation,
    hence the flip. Differentiable in G's weights."""
    sup = _support(conf)
    n = 2 * sup - 1  # the VALID response to a centred delta is exactly (sup, sup)
    w = g.conv0.weight
    delta = torch.zeros((1, n, n, 1), dtype=w.dtype, device=w.device)
    delta[0, n // 2, n // 2, 0] = 1.0
    return g(delta, stride=False)[0, :, :, 0].flip(0, 1)


def _kernel_regularizers(k: torch.Tensor, conf: KernelGANConf) -> torch.Tensor:
    sup = k.shape[0]
    idx = torch.arange(sup, dtype=k.dtype, device=k.device)
    center = (sup - 1) / 2.0
    # boundary mask: grows quadratically away from the centre
    d2 = ((idx - center) ** 2)[:, None] + ((idx - center) ** 2)[None, :]
    boundary_mask = d2 / d2.max()
    ak = jax_abs(k)
    loss = conf.w_sum2one * jax_abs(1.0 - torch.sum(k))
    loss = loss + conf.w_boundaries * torch.sum(ak * boundary_mask)
    if conf.w_centralized:
        mass = torch.sum(ak) + 1e-8
        com_h = torch.sum(ak * idx[:, None]) / mass
        com_w = torch.sum(ak * idx[None, :]) / mass
        loss = loss + conf.w_centralized * ((com_h - center) ** 2 + (com_w - center) ** 2)
    if conf.w_sparse:
        loss = loss + conf.w_sparse * torch.mean(torch.sqrt(ak + 1e-8))
    return loss


def _lsgan(logits: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean((logits - target) ** 2)


def make_kernelgan_step(g: LinearKernelG, d: PatchD, conf: KernelGANConf, g_opt: Adam, d_opt: Adam):
    """One (G update, D update) iteration ``step(g_in, real) -> metrics``:
    ``g_in`` a (1, g_input, g_input, 1) crop, ``real`` a (1, fake, fake, 1)
    crop (:func:`_fake_size`). G's loss is LSGAN against the pre-update D
    plus the kernel regularizers; D then learns real vs G's detached fakes.
    The metrics stay 0-d tensors on the device."""

    def step(g_in: torch.Tensor, real: torch.Tensor) -> dict:
        with full_f32(), torch.enable_grad():
            fake = g(g_in)
            adv = _lsgan(d(fake), 1.0)
            reg = _kernel_regularizers(effective_kernel(g, conf), conf)
            l_g = adv + reg
            g_grads = torch.autograd.grad(l_g, g_opt.params)
        g_opt.step(list(g_grads), conf.lr_g)
        fake = fake.detach()
        with full_f32(), torch.enable_grad():
            l_d = (_lsgan(d(real), 1.0) + _lsgan(d(fake), 0.0)) / 2.0
            d_grads = torch.autograd.grad(l_d, d_opt.params)
        d_opt.step(list(d_grads), conf.lr_d)
        return {"l_g": l_g.detach(), "l_d": l_d.detach(), "adv": adv.detach(), "reg": reg.detach()}

    return step


def make_override_step(g: LinearKernelG, conf: KernelGANConf, g_opt: Adam, loss_override):
    """The supervised/testing step ``step(g_in) -> metrics``: the adversarial
    term is ``loss_override(fake, g_in)``; no D."""

    def step(g_in: torch.Tensor) -> dict:
        with full_f32(), torch.enable_grad():
            fake = g(g_in)
            main = loss_override(fake, g_in)
            reg = _kernel_regularizers(effective_kernel(g, conf), conf)
            l_g = main + reg
            g_grads = torch.autograd.grad(l_g, g_opt.params)
        g_opt.step(list(g_grads), conf.lr_g)
        return {"l_g": l_g.detach(), "l_d": torch.zeros_like(l_g), "adv": main.detach(), "reg": reg.detach()}

    return step


def conf_for_image(shape, scale: int = 4, iters: int = 2000, seed: int = 0) -> KernelGANConf:
    """A conf sized to the image: g_input 64 when it fits, else the smallest
    crop whose VALID fakes still cover D's receptive field (48 at the
    default architecture). Raises for images below that."""
    m = min(int(shape[0]), int(shape[1]))
    base = KernelGANConf(scale=scale, iters=iters, seed=seed)
    need = _support(base) - 1 + scale * _d_receptive(base)  # = 48 at defaults
    if m >= base.g_input:
        return base
    if m >= need:
        return dataclasses.replace(base, g_input=need)
    raise ValueError(
        f"image {tuple(shape[:2])} too small for kernel estimation "
        f"(needs >= {need}px on the short side at the default architecture)"
    )


def _crop(img: torch.Tensor, oy: int, ox: int, size: int) -> torch.Tensor:
    """(H, W, 1) image -> its (1, size, size, 1) crop at (oy, ox)."""
    return img[oy : oy + size, ox : ox + size][None]


def estimate_kernel(lr_image: np.ndarray, conf: KernelGANConf | None = None, progress=None,
                    loss_override=None, device: str | torch.device = "cuda") -> tuple[np.ndarray, dict]:
    """Estimate the downsampling kernel of ``lr_image`` (HWC or HW float in
    [0, 1]) on ``device``. Returns ``(kernel, metrics)``: a unit-sum
    (support, support) float64 kernel for ``opt['kernel']`` /
    ``CEMConf(kernel=...)``, and the last iteration's loss scalars.

    It runs on the image's channel mean (the kernel is shared across RGB).
    ``progress(done, total, metrics)`` is called after every chunk of
    ``CHUNK`` iterations. ``loss_override(fake, g_in)`` replaces the
    adversarial term (a supervised L2 to an oracle downsample turns the GAN
    into a deterministic inverse problem)."""
    conf = conf or KernelGANConf()
    dev = resolve_device(device)
    img = np.asarray(lr_image, np.float32)
    if img.ndim == 3:
        img = img.mean(axis=-1)  # the kernel is colour-agnostic
    if min(img.shape) < conf.g_input:
        raise ValueError(f"image {img.shape} smaller than g_input {conf.g_input}; shrink KernelGANConf.g_input")
    if conf.g_input < _support(conf):
        raise ValueError(f"g_input {conf.g_input} smaller than the composite G support {_support(conf)}; "
                         "enlarge g_input or shrink g_kernels")
    h, w = img.shape
    img_t = torch.from_numpy(np.ascontiguousarray(img[..., None])).to(dev)

    g = LinearKernelG(conf, seed=conf.seed).to(dev)
    g_opt = Adam(g.parameters(), b1=0.5)
    if loss_override is not None:
        step = make_override_step(g, conf, g_opt, loss_override)
    else:
        if _fake_size(conf) < _d_receptive(conf):
            raise ValueError(
                f"G produces {_fake_size(conf)}px LR patches from g_input {conf.g_input} (VALID support "
                f"{_support(conf)}, scale {conf.scale}) but D's receptive field is {_d_receptive(conf)}px;"
                " enlarge g_input or shrink d_kernels")
        d = PatchD(conf, seed=conf.seed + 1).to(dev)
        step = make_kernelgan_step(g, d, conf, g_opt, Adam(d.parameters(), b1=0.5))
    fake = _fake_size(conf)
    gen = torch.Generator().manual_seed(conf.seed)
    metrics: dict = {}
    for lo in range(0, conf.iters, CHUNK):
        n = min(CHUNK, conf.iters - lo)
        # the chunk's crop offsets, drawn on the host: (fake y, fake x, real y, real x)
        oy = torch.randint(0, h - conf.g_input + 1, (n, 1), generator=gen)
        ox = torch.randint(0, w - conf.g_input + 1, (n, 1), generator=gen)
        ry = torch.randint(0, h - fake + 1, (n, 1), generator=gen)
        rx = torch.randint(0, w - fake + 1, (n, 1), generator=gen)
        for fy, fx, y, x in torch.cat([oy, ox, ry, rx], 1).tolist():
            g_in = _crop(img_t, fy, fx, conf.g_input)
            m = step(g_in) if loss_override is not None else step(g_in, _crop(img_t, y, x, fake))
        vals = torch.stack(list(m.values())).tolist()  # the chunk's one read from the device
        metrics = dict(zip(m, vals))
        if progress is not None:
            progress(lo + n, conf.iters, dict(metrics))
    with torch.no_grad():
        k = effective_kernel(g, conf).double().cpu().numpy()
    if k.sum() <= 1e-8:  # a degenerate sign: keep it normalizable
        k = np.abs(k)
    return k / k.sum(), metrics
