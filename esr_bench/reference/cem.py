"""The CEM projection, written out (Bahat & Michaeli, CVPR 2020, eq. 3-5).

The LR image is ``y = H x``: MATLAB's antialiased bicubic downscale by
``s`` with circular boundaries, which is separable, ``H = A_h (x) A_w``.
The projection returns ``x + P_h (y - A_h x A_w^T) P_w^T`` with the per-axis
pseudo-inverse ``P = A^T (A A^T)^{-1}``, so that ``H`` of the result is
``y``. The 1-D kernel comes from MATLAB's cubic (Keys, a = -0.5) stretched
by ``s``; the matrices are built in float64 and applied in float32 (TF32
off: the configuration states f32), or in TF32 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Cem", "bicubic_kernel"]


def _cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return ((1.5 * x**3 - 2.5 * x**2 + 1.0) * (x <= 1.0)
            + (-0.5 * x**3 + 2.5 * x**2 - 4.0 * x + 2.0) * ((x > 1.0) & (x < 2.0)))


def bicubic_kernel(s: int) -> tuple[np.ndarray, int]:
    """``(k, rel)``: ``y[j] = sum_i x[j*s + rel + i] k[i]`` is MATLAB's
    ``imresize(x, 1/s)`` away from the borders. Output pixel j (0-based) sits
    at input coordinate ``(j + 1) s + (1 - s) / 2`` (1-based), and the
    antialiased kernel is ``cubic(d / s) / s``, normalised to sum 1."""
    u = s + 0.5 * (1 - s)
    taps = np.arange(int(np.floor(u - 2 * s)), int(np.ceil(u + 2 * s)) + 1)  # 1-based
    w = _cubic((u - taps) / s) / s
    keep = np.abs(w) > 1e-14
    taps, w = taps[keep], w[keep]
    return w / w.sum(), int(taps[0] - 1)


class Cem:
    """``project(raw, lr)`` and ``downsample(x)`` for NHWC tensors, scale ``s``."""

    def __init__(self, scale: int, device):
        self.s = int(scale)
        self.device = torch.device(device)
        self.k, self.rel = bicubic_kernel(self.s)
        self._mats: dict = {}

    def mats(self, n_lr: int, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
        """``A`` (n_lr, s n_lr), circular, and ``P = A^T (A A^T)^{-1}``."""
        key = (n_lr, dtype)
        if key not in self._mats:
            n_hr = n_lr * self.s
            a = np.zeros((n_lr, n_hr))
            for j in range(n_lr):
                for i, kv in enumerate(self.k):
                    a[j, (j * self.s + self.rel + i) % n_hr] += kv
            p = a.T @ np.linalg.inv(a @ a.T)
            self._mats[key] = tuple(torch.as_tensor(m, dtype=dtype, device=self.device) for m in (a, p))
        return self._mats[key]

    def downsample(self, x: torch.Tensor) -> torch.Tensor:
        """``H x`` in ``x.dtype`` (float64 for the residual of an answer)."""
        a_h, _ = self.mats(x.shape[1] // self.s, x.dtype)
        a_w, _ = self.mats(x.shape[2] // self.s, x.dtype)
        return torch.einsum("kw,njwc->njkc", a_w, torch.einsum("jh,nhwc->njwc", a_h, x))

    def upscale(self, y: torch.Tensor) -> torch.Tensor:
        """``H^+ y``, the consistent upscale (the answer's low-frequency part)."""
        _, p_h = self.mats(y.shape[1], y.dtype)
        _, p_w = self.mats(y.shape[2], y.dtype)
        return torch.einsum("qk,npkc->npqc", p_w, torch.einsum("pj,njkc->npkc", p_h, y))

    def project(self, raw: torch.Tensor, lr: torch.Tensor, tf32: bool = False) -> torch.Tensor:
        """``raw + H^+ (lr - H raw)`` in float32; ``tf32``: the control's matmuls."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            raw, lr = raw.float(), lr.float()
            return raw + self.upscale(lr - self.downsample(raw))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
