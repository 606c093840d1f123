"""Z-search objectives (port of esr_tpu/explore/objectives.py).

The tools of the editor reduce to objectives over a selected region of the
super-resolved image: L1 to a desired image ("imprint"), local variance up
or down, brightness, TV smoothing, periodicity, soft-histogram match,
random diverse alternatives and the discriminator's realism score.

Each tool's function returns an :class:`Objective`: ``fn(sr, mask, aux) -> 0-d
tensor`` with ``sr`` (N, H, W, C) and the region ``mask`` (H, W) float, its
parameters ``aux`` and ``spatial``, the keys of ``aux`` that are HR-space
images (last three dims (H, W, C)) and are cropped with the region
(``crop_hr``). ``Objective(sr, mask)`` calls it.

The functions are written to the JAX package's formulas, and where it takes
``jnp.abs`` the port takes :func:`jax_abs`, whose gradient at 0 is JAX's (1),
not torch's (0): where ``sr`` equals a target exactly (an imprint target
outside the painted text, say), JAX's search moves Z and so does the port's.
The realism tool resizes the crop to D's input with :func:`resize_bilinear`,
the weight matrices of ``jax.image.resize(..., "bilinear")`` (antialiased
when it shrinks), which ``F.interpolate`` does not compute.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from esr_tpu_torch.models.losses import jax_abs, local_std

__all__ = [
    "Objective",
    "adversarial_objective",
    "brightness_objective",
    "histogram_objective",
    "imprint_objective",
    "jax_abs",
    "periodicity_objective",
    "random_diverse_objective",
    "resize_bilinear",
    "tv_objective",
    "variance_objective",
]


class Objective(NamedTuple):
    """A Z-search objective: ``fn`` and its parameters ``aux``; ``spatial``
    lists keys of ``aux`` whose trailing dims are ``(H_hr, W_hr, C)`` and are
    cropped with the region."""

    fn: Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]
    aux: dict[str, Any] | None = None
    spatial: tuple[str, ...] = ()

    def __call__(self, sr, mask):
        return self.fn(sr, mask, self.aux or {})

    def crop_hr(self, y_hr: int, x_hr: int, size_hr: int) -> "Objective":
        """A copy with every spatial aux cropped to the HR window."""
        if not self.spatial:
            return self
        aux = dict(self.aux or {})
        for k in self.spatial:
            aux[k] = aux[k][..., y_hr : y_hr + size_hr, x_hr : x_hr + size_hr, :]
        return self._replace(aux=aux)

    def to(self, device: torch.device) -> "Objective":
        """A copy with every tensor in ``aux`` on ``device``."""
        aux = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in (self.aux or {}).items()}
        return self._replace(aux=aux)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x weighted by mask broadcast over batch/channel dims."""
    m = mask[None, :, :, None]
    return torch.sum(x * m) / (torch.sum(m) * x.shape[0] * x.shape[-1] + 1e-12)


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32) if not isinstance(v, torch.Tensor) else v,
                           dtype=torch.float32, device=device)


# -- imprint ----------------------------------------------------------------


def _imprint_fn(sr, mask, aux):
    return _masked_mean(jax_abs(sr - aux["target"][None]), mask)


def imprint_objective(target) -> Objective:
    """L1 to a desired image (graffiti / imprinting tool). ``target`` is a
    full-size (H, W, C) HR image (content outside the mask is ignored)."""
    return Objective(_imprint_fn, {"target": _f32(target)}, ("target",))


# -- local variance -----------------------------------------------------------


@lru_cache(maxsize=None)
def _variance_fn(window: int):
    def fn(sr, mask, aux):
        return -aux["direction"] * _masked_mean(local_std(sr, window), mask)

    return fn


def variance_objective(direction: float = 1.0, window: int = 7) -> Objective:
    """Push local std up (direction > 0) or down (direction < 0) in the region."""
    return Objective(_variance_fn(int(window)), {"direction": float(np.float32(direction))})


# -- brightness ---------------------------------------------------------------


def _brightness_fn(sr, mask, aux):
    return (_masked_mean(sr, mask) - aux["target_level"]) ** 2


def brightness_objective(target_level: float) -> Objective:
    """Drive the region's mean intensity toward ``target_level``."""
    return Objective(_brightness_fn, {"target_level": float(np.float32(target_level))})


# -- total variation ----------------------------------------------------------


def _tv_fn(sr, mask, aux):
    dh = jax_abs(sr[:, 1:] - sr[:, :-1]) * mask[None, 1:, :, None]
    dw = jax_abs(sr[:, :, 1:] - sr[:, :, :-1]) * mask[None, :, 1:, None]
    denom = torch.sum(mask) * sr.shape[0] * sr.shape[-1] + 1e-12
    return (torch.sum(dh) + torch.sum(dw)) / denom


def tv_objective() -> Objective:
    """Total-variation smoothing of the region."""
    return Objective(_tv_fn)


# -- periodicity --------------------------------------------------------------


def _shift_axis(x: torch.Tensor, d: float, axis: int) -> torch.Tensor:
    """``x`` read at index + d along ``axis`` (``jnp.roll`` wraps): two rolls
    and a blend; a whole d is one roll (the fraction blends the other out)."""
    lo = torch.roll(x, -math.floor(d), dims=axis)
    hi = torch.roll(x, -math.ceil(d), dims=axis)
    frac = d - math.floor(d)
    return lo * (1 - frac) + hi * frac


def _valid_band(n: int, d: float, dtype, device) -> torch.Tensor:
    """Positions whose shifted source stays inside the image: the rolls wrap,
    so without it the loss would compare opposite borders."""
    idx = torch.arange(n, device=device)
    return ((idx + math.floor(d) >= 0) & (idx + math.ceil(d) <= n - 1)).to(dtype)


def _shift_loss(sr, mask, d: float, axis: int) -> torch.Tensor:
    h, w = mask.shape
    shifted = _shift_axis(sr, d, axis)
    sm = _shift_axis(mask[None, :, :, None], d, axis)[0, :, :, 0]
    band = _valid_band(h if axis == 1 else w, d, mask.dtype, mask.device)
    sm = sm * (band[:, None] if axis == 1 else band[None, :])
    return _masked_mean(jax_abs(sr - shifted), mask * sm)  # only where both are in the region


@lru_cache(maxsize=None)
def _periodicity_fn(shifts: tuple[tuple[float, float], ...]):
    """The static form: a fixed tuple of (dy, dx) shifts, each shifted along
    both axes in turn (JAX ``_periodicity_fn``)."""

    def fn(sr, mask, aux):
        h, w = mask.shape
        loss = 0.0
        for dy, dx in shifts:
            shifted, sm = sr, mask[None, :, :, None]
            if dy:
                shifted, sm = _shift_axis(shifted, dy, 1), _shift_axis(sm, dy, 1)
            if dx:
                shifted, sm = _shift_axis(shifted, dx, 2), _shift_axis(sm, dx, 2)
            sm = sm[0, :, :, 0]
            if dy:
                sm = sm * _valid_band(h, dy, mask.dtype, mask.device)[:, None]
            if dx:
                sm = sm * _valid_band(w, dx, mask.dtype, mask.device)[None, :]
            loss = loss + _masked_mean(jax_abs(sr - shifted), mask * sm)
        return loss / len(shifts)

    return fn


def _periodicity_dyn_fn(sr, mask, aux):
    """The periods as parameters (JAX ``_periodicity_dyn_fn``, its traced
    twin): each axis with a nonzero period adds its shift loss, and the sum is
    divided by how many did."""
    total, wsum = 0.0, 0.0
    for key, axis in (("py", 1), ("px", 2)):
        d = float(aux[key])
        if d:
            total = total + _shift_loss(sr, mask, d, axis)
            wsum += 1.0
    return total / (float(np.float32(wsum)) + 1e-12)


def periodicity_objective(period_y: float = 0.0, period_x: float = 0.0) -> Objective:
    """Self-similarity of the region under a shift of (period_y, period_x)
    pixels (1-D or 2-D periodicity tool); fractional periods blend two shifts."""
    if not (period_y or period_x):
        raise ValueError("need a nonzero period")
    return Objective(_periodicity_dyn_fn, {"py": float(np.float32(period_y)), "px": float(np.float32(period_x))})


# -- random diverse alternatives ------------------------------------------------


def _diverse_fn(sr, mask, aux):
    anchors, w = aux["anchors"], aux["anchor_w"]  # (K, H, W, C); (K,) 1 live, 0 padding
    d = jax_abs(sr[None] - anchors[:, None])  # (K, N, H, W, C)
    m = mask[None, None, :, :, None]
    per = torch.sum(d * m, dim=(1, 2, 3, 4)) / (torch.sum(m) * d.shape[1] * d.shape[-1] + 1e-12)
    repel = torch.sum(per * w) / (torch.sum(w) + 1e-12)
    return -aux["weight_repel"] * repel


def random_diverse_objective(anchors, weight_repel: float = 1.0, anchor_weights=None) -> Objective:
    """An alternative that moves away from earlier outputs ``anchors`` (K, H,
    W, C); ``anchor_weights`` (K,) 0 marks padding rows."""
    anchors = _f32(anchors)
    if anchor_weights is None:
        anchor_weights = torch.ones(anchors.shape[0])
    return Objective(
        _diverse_fn,
        {"anchors": anchors, "anchor_w": _f32(anchor_weights), "weight_repel": float(np.float32(weight_repel))},
        ("anchors",),
    )


# -- histogram / texture match ---------------------------------------------------


def _soft_hist(values: torch.Tensor, weights: torch.Tensor, sigma: float, n_bins: int) -> torch.Tensor:
    """Gaussian-kernel histograms per channel of ``values`` (M, C) with region
    ``weights`` (M, 1), normalized: (n_bins, C)."""
    centers = torch.linspace(0.0, 1.0, n_bins, device=values.device)
    d = values[:, None, :] - centers[None, :, None]  # (M, bins, C)
    k = torch.exp(-0.5 * (d / sigma) ** 2) * weights[:, :, None]
    h = torch.sum(k, dim=0)
    return h / (torch.sum(h, dim=0, keepdim=True) + 1e-12)


@lru_cache(maxsize=None)
def _histogram_fn(n_bins: int):
    def fn(sr, mask, aux):
        vals = sr.reshape(-1, sr.shape[-1])
        w = torch.broadcast_to(mask[None, :, :], sr.shape[:3]).reshape(-1, 1)
        return torch.mean(jax_abs(_soft_hist(vals, w, aux["sigma"], n_bins) - aux["tgt_hist"]))

    return fn


def histogram_objective(target_patch, n_bins: int = 32, sigma: float = 0.05) -> Objective:
    """Match the region's intensity distribution to a target patch's: L1
    between soft histograms per channel. ``target_patch`` (h, w, C) or (K, C)
    is a sample of intensities, not an aligned image, so it is not cropped;
    its histogram is computed once, here."""
    tgt = _f32(target_patch)
    tgt = tgt.reshape(-1, tgt.shape[-1])
    sigma = float(np.float32(sigma))
    h_tgt = _soft_hist(tgt, torch.ones(tgt.shape[0], 1), sigma, int(n_bins))
    return Objective(_histogram_fn(int(n_bins)), {"tgt_hist": h_tgt, "sigma": sigma})


# -- adversarial -----------------------------------------------------------------


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.scale_and_translate`` with the
    triangle kernel, scale n_out / n_in, no translation, antialias: the kernel
    is widened by 1 / scale when shrinking, each output's weights are
    renormalized to sum 1, and outputs sampled outside the input get none."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)  # (n_in, n_out)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return w.T


@lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    return torch.from_numpy(_triangle_weights(n_in, n_out).astype(np.float32))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, (N, out_h, out_w, C), "bilinear")`` (antialias
    on) of an NHWC tensor: one weight matrix per axis, H then W."""
    _, h, w, _ = x.shape
    if h != out_h:
        x = torch.einsum("oh,nhwc->nowc", _resize_matrix(h, out_h).to(x.device, x.dtype), x)
    if w != out_w:
        x = torch.einsum("pw,nowc->nopc", _resize_matrix(w, out_w).to(x.device, x.dtype), x)
    return x


def d_input_size(d_module) -> int:
    """The discriminator's trained input size, from its head: ``linear1``
    takes nf * 8 x (s / 32)^2 features for an s-pixel crop."""
    nf = int(d_module.conv0_0.weight.shape[0])
    lin_in = int(d_module.linear1.weight.shape[1])
    return round((lin_in / (nf * 8)) ** 0.5) * 32


def _adversarial_fn(sr, mask, aux):
    m = mask[None, :, :, None]
    # D scores the whole crop for context, but gradients flow only through
    # the region's pixels
    x = sr * m + sr.detach() * (1.0 - m)
    s = aux["d_input"]
    if x.shape[1:3] != (s, s):
        x = resize_bilinear(x, s, s)
    logits = aux["d_module"](x, train=False)
    return -aux["direction"] * torch.mean(logits)


def adversarial_objective(d_module, direction: float = 1.0) -> Objective:
    """Drive the discriminator's realism score of the region up (direction >
    0) or down. ``d_module``: a frozen ``DiscriminatorVGG128`` (the saved
    ``*_D.pth`` loaded into ``define_D``); its input size is read from its head."""
    return Objective(_adversarial_fn, {"d_module": d_module, "d_input": d_input_size(d_module),
                                       "direction": float(np.float32(direction))})
