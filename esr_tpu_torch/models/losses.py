"""Loss library (port of esr_tpu/models/losses.py).

- ``gan_loss``: vanilla (BCE with logits) / lsgan (MSE) / wgan(-gp); the
  trainer applies it relativistically (ESRGAN's RaGAN: the loss on
  ``D(x) - mean(D(y))``) unless ``relativistic`` is false (SRGAN).
- ``gradient_penalty``: the WGAN-GP penalty, through a double backward.
- ``range_loss``: the overshoot outside [0, 1] (the CEM-wrapped output is
  unbounded).
- ``map_loss``: ties the local-std difference between SR and HR to the
  window-averaged Z map, which makes Z a variance control.
- ``pixel_loss`` (l1 / l2 / Charbonnier), ``perceptual_l1``, ``tv_loss``.
- ``jax_abs``: ``|x|`` with ``jnp.abs``'s gradient (1 at 0, where torch's
  is 0), for the losses whose JAX originals take ``jnp.abs``.

Tensors are NHWC, as in the JAX package. Pure functions of tensors ->
0-d tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "charbonnier",
    "gan_loss",
    "gradient_penalty",
    "jax_abs",
    "local_std",
    "map_loss",
    "perceptual_l1",
    "pixel_loss",
    "ragan_d_loss",
    "ragan_g_loss",
    "range_loss",
    "tv_loss",
]


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's gradient: sign(x), and 1 at x = 0 (torch gives 0)."""
    return x * torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs())))


def gan_loss(logits: torch.Tensor, target_is_real: bool, gan_type: str = "vanilla") -> torch.Tensor:
    if gan_type == "vanilla":
        return _bce_logits(logits, 1.0 if target_is_real else 0.0)
    if gan_type == "lsgan":
        return torch.mean((logits - (1.0 if target_is_real else 0.0)) ** 2)
    if gan_type in ("wgan-gp", "wgan"):
        return -torch.mean(logits) if target_is_real else torch.mean(logits)
    raise ValueError(f"unknown gan_type {gan_type}")


def ragan_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor, gan_type: str = "vanilla",
                 relativistic: bool = True) -> torch.Tensor:
    """Discriminator loss: relativistic average (ESRGAN) or standard (SRGAN)."""
    if not relativistic:
        return (gan_loss(d_real, True, gan_type) + gan_loss(d_fake, False, gan_type)) / 2.0
    lr = gan_loss(d_real - torch.mean(d_fake), True, gan_type)
    lf = gan_loss(d_fake - torch.mean(d_real), False, gan_type)
    return (lr + lf) / 2.0


def ragan_g_loss(d_real: torch.Tensor, d_fake: torch.Tensor, gan_type: str = "vanilla",
                 relativistic: bool = True) -> torch.Tensor:
    """Generator adversarial loss: relativistic average, or standard (d_real unused)."""
    if not relativistic:
        return gan_loss(d_fake, True, gan_type)
    lr = gan_loss(d_real - torch.mean(d_fake), False, gan_type)
    lf = gan_loss(d_fake - torch.mean(d_real), True, gan_type)
    return (lr + lf) / 2.0


def gradient_penalty(d_apply, real: torch.Tensor, fake: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """WGAN-GP penalty at the interpolates ``eps * real + (1 - eps) * fake``
    (eps: (N, 1, 1, 1) in [0, 1)); ``d_apply(x) -> logits``. The input
    gradient keeps its graph, so the penalty trains D's parameters."""
    interp = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(interp).sum(), interp, create_graph=True)
    gnorm = torch.sqrt(torch.sum(grads**2, dim=(1, 2, 3)) + 1e-12)
    return torch.mean((gnorm - 1.0) ** 2)


def range_loss(x: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Mean overshoot outside [lo, hi]."""
    return torch.mean((x - hi).clamp(min=0.0) + (lo - x).clamp(min=0.0))


def _box_mean(x: torch.Tensor, size: int) -> torch.Tensor:
    """Depthwise box mean over a size x size window, SAME zero padding, NHWC."""
    c = x.shape[-1]
    w = x.new_full((c, 1, size, size), 1.0 / (size * size))
    lo = (size - 1) // 2
    xc = F.pad(x.permute(0, 3, 1, 2), (lo, size - 1 - lo, lo, size - 1 - lo))
    return F.conv2d(xc, w, groups=c).permute(0, 2, 3, 1)


def local_std(x: torch.Tensor, window_size: int = 7) -> torch.Tensor:
    """Per-pixel local standard deviation over a box window (NHWC -> NHWC)."""
    mu = _box_mean(x, window_size)
    var = _box_mean(x * x, window_size) - mu * mu
    return torch.sqrt(var.clamp(min=1e-10))


def map_loss(sr: torch.Tensor, hr: torch.Tensor, z: torch.Tensor, window_size: int = 7,
             gain: float = 0.1) -> torch.Tensor:
    """``mean((localstd(sr) - localstd(hr) - gain * mean_c(box(z)))^2)``, Z
    nearest-upsampled from the LR grid."""
    s_sr = torch.mean(local_std(sr, window_size), dim=-1)
    s_hr = torch.mean(local_std(hr, window_size), dim=-1)
    if z.shape[1] != sr.shape[1]:
        f = sr.shape[1] // z.shape[1]
        z = z.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
    z_avg = torch.mean(_box_mean(z, window_size), dim=-1)
    return torch.mean((s_sr - s_hr - gain * z_avg) ** 2)


def charbonnier(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.mean(torch.sqrt(x * x + eps * eps))


def pixel_loss(sr: torch.Tensor, hr: torch.Tensor, kind: str = "l1") -> torch.Tensor:
    if kind == "l1":
        return torch.mean(torch.abs(sr - hr))
    if kind == "l2":
        return torch.mean((sr - hr) ** 2)
    if kind == "cb":
        return charbonnier(sr - hr)
    raise ValueError(f"unknown pixel loss {kind}")


def perceptual_l1(feat_sr: torch.Tensor, feat_hr: torch.Tensor) -> torch.Tensor:
    """ESRGAN feature loss: L1 in pre-activation VGG space."""
    return torch.mean(torch.abs(feat_sr - feat_hr))


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation."""
    return torch.mean(torch.abs(x[:, 1:] - x[:, :-1])) + torch.mean(torch.abs(x[:, :, 1:] - x[:, :, :-1]))
