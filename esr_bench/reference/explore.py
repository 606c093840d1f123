"""The editor's Z search, written out (Bahat & Michaeli, CVPR 2020, sec. 4
and the editor's tools): for a selected region, Adam on the Z map of a
square crop around it minimises a tool's objective on the CEM-consistent SR
of the crop, Z clipped to [-1, 1] after each update; the crop's Z is then
pasted back. ``forward(lr, z)`` is the CEM-projected generator.

- crop: the region's LR box rounded up to the first of 16, 32, 64, 128,
  256 that holds it, centred on the box and moved inside the image;
- objectives, over the HR mask ``m`` (1 inside): ``mean_m`` is ``sum(x m) /
  (sum(m) N C)``; variance ``-d mean_m(local_std_7(sr))`` (box std over a
  7 x 7 window, zero padding), brightness ``(mean_m(sr) - t)^2``, smooth
  ``(sum |dy sr| m + sum |dx sr| m) / (sum(m) N C)``;
- Adam as optax's (b1 0.9, b2 0.999, eps 1e-8, ``m_hat / (sqrt(v_hat) +
  eps)``), learning rate 0.1, the objective read before each update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["crop_box", "objective", "z_search"]

BUCKETS = (16, 32, 64, 128, 256)


def crop_box(box: tuple[int, int, int, int], h: int, w: int) -> tuple[int, int, int]:
    """``(y, x, size)`` of the search's LR crop for the LR box (y0, x0, y1, x1)."""
    y0, x0, y1, x1 = box
    need = max(y1 - y0, x1 - x0)
    size = min(next((b for b in BUCKETS if b >= need), max(h, w)), min(h, w))
    return min(max(0, (y0 + y1 - size) // 2), h - size), min(max(0, (x0 + x1 - size) // 2), w - size), size


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * m[None, :, :, None]) / (torch.sum(m) * x.shape[0] * x.shape[-1] + 1e-12)


def _box(x: torch.Tensor, k: int) -> torch.Tensor:
    c = x.shape[-1]
    lo = (k - 1) // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (lo, k - 1 - lo, lo, k - 1 - lo))
    return F.conv2d(xp, x.new_full((c, 1, k, k), 1.0 / (k * k)), groups=c).permute(0, 2, 3, 1)


def objective(tool: dict, sr: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The tool's loss (``tool``: ``{"name": ..., and its parameter}``)."""
    name = tool["name"]
    if name in ("increase_variance", "decrease_variance"):
        d = 1.0 if name == "increase_variance" else -1.0
        var = _box(sr * sr, 7) - _box(sr, 7) ** 2
        return -d * _masked_mean(torch.sqrt(var.clamp(min=1e-10)), m)
    if name == "brightness":
        return (_masked_mean(sr, m) - tool["level"]) ** 2
    if name == "smooth":
        dh = (sr[:, 1:] - sr[:, :-1]).abs() * m[None, 1:, :, None]
        dw = (sr[:, :, 1:] - sr[:, :, :-1]).abs() * m[None, :, 1:, None]
        return (dh.sum() + dw.sum()) / (torch.sum(m) * sr.shape[0] * sr.shape[-1] + 1e-12)
    raise ValueError(f"unknown tool {name!r}")


def z_search(forward, lr: torch.Tensor, z: torch.Tensor, m: torch.Tensor, tool: dict, steps: int,
             lr_z: float = 0.1, z_range: float = 1.0) -> torch.Tensor:
    """Z after ``steps`` Adam updates from ``z`` on the crop (lr, z, mask ``m`` in HR)."""
    z = z.detach().clone().float()
    mu, nu = torch.zeros_like(z), torch.zeros_like(z)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, steps + 1):
        zl = z.requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(objective(tool, forward(lr, zl), m), zl)
        z = z.detach()
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        z = (z - lr_z * (mu / (1 - b1**t)) / (torch.sqrt(nu / (1 - b2**t)) + eps)).clamp(-z_range, z_range)
    return z
