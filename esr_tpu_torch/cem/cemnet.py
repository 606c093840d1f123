"""CEM — Consistency Enforcing Module (port of esr_tpu/cem/cemnet.py).

Given the downsampling ``y = (x * k) v s`` written as the operator ``H``,
the projection outputs

    x_out = H^T (H H^T)^{-1} y  +  (I - H^T (H H^T)^{-1} H) . G(y, Z)

so that ``H x_out = y`` exactly for any generator output. With a separable
kernel (the MATLAB-bicubic default) and circular boundaries, H = A_h (x) A_w
and the projection is a handful of dense f32 matmuls over per-axis matrices
built on the host in f64 (``matmul`` mode, what ``inv_mode='auto'`` picks).
The matmuls run in full f32: the JAX package asks for ``Precision.HIGHEST``
here, so keep ``torch.backends.cuda.matmul.allow_tf32`` False (its default).
The ``fft`` and ``filter`` modes are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from esr_tpu_torch.cem.kernels import bicubic_downsample_kernel_1d, downsample_kernel_2d
from esr_tpu_torch.device import resolve_device

__all__ = ["CEMConf", "CEM", "make_cem"]

_NOT_PORTED = "CEM inv_mode {!r} is not ported yet (ROADMAP.md Queue 1 item 3: CEM fft/filter modes)"


@dataclasses.dataclass(frozen=True)
class CEMConf:
    scale: int = 4
    kernel: tuple | None = None  # optional custom 1-D/2-D kernel (nested tuples)
    eps: float = 1e-7  # magnitude floor for the frequency-domain inverse
    pad_lr: int = 0  # replicate pre-padding (LR pixels) to hide wraparound
    inv_mode: str = "auto"  # 'auto' | 'matmul' ('fft' | 'filter' not ported)
    inv_filter_support: int = 21  # spatial support (LR px) for 'filter' mode


class CEM:
    """Consistency-Enforcing Module: analytic projection onto {x : Hx = y}."""

    def __init__(self, conf: CEMConf, device: str | torch.device = "cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        s = int(conf.scale)
        kernel = None if conf.kernel is None else np.asarray(conf.kernel)
        k2d, (rel_h, rel_w) = downsample_kernel_2d(s, kernel)
        self.k2d = k2d
        self.rel = (rel_h, rel_w)
        self.scale = s
        # separable fast path: 1-D kernel + phase (bicubic or provided 1-D)
        self._k1 = self._rel1 = None
        if kernel is None:
            self._k1, self._rel1 = bicubic_downsample_kernel_1d(s)
        elif kernel.ndim == 1:
            k1 = kernel / kernel.sum()
            self._k1, self._rel1 = k1, -(len(k1) - s) // 2
        mode = conf.inv_mode
        if mode == "auto":
            mode = "matmul" if self._k1 is not None else "fft"
        if mode in ("fft", "filter"):
            raise NotImplementedError(_NOT_PORTED.format(mode))
        if mode != "matmul":
            raise ValueError(f"unknown inv_mode {conf.inv_mode!r}")
        if self._k1 is None:
            raise ValueError("inv_mode='matmul' requires a separable kernel")
        self._mode = mode
        self._mat_cache: dict = {}

    # -- separable matmul realization -------------------------------------

    def _axis_matrices(self, n_lr: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-axis circular operators as dense f32 matrices on the device
        (cached per size). A (n_lr, n_hr): one axis of H. P = A^T (A A^T)^{-1}
        (n_hr, n_lr): one axis of the consistent upscale, exact in f64 (the
        bicubic autocorrelation has cond ~ 2)."""
        if n_lr in self._mat_cache:
            return self._mat_cache[n_lr]
        s = self.scale
        n_hr = n_lr * s
        a = np.zeros((n_lr, n_hr))
        for j in range(n_lr):
            base = s * j + self._rel1
            for i, kv in enumerate(self._k1):
                a[j, (base + i) % n_hr] += kv
        p = a.T @ np.linalg.inv(a @ a.T)
        mats = tuple(
            torch.as_tensor(m.astype(np.float32), device=self.device) for m in (a, p)
        )
        self._mat_cache[n_lr] = mats
        return mats

    def _matmul_downsample(self, x: torch.Tensor) -> torch.Tensor:
        a_h, _ = self._axis_matrices(x.shape[1] // self.scale)
        a_w, _ = self._axis_matrices(x.shape[2] // self.scale)
        y = torch.einsum("jh,nhwc->njwc", a_h, x.float())
        return torch.einsum("kw,njwc->njkc", a_w, y)

    def _matmul_upscale(self, y: torch.Tensor) -> torch.Tensor:
        """P_h (x) P_w: the consistent (DT-satisfying) upscale."""
        _, p_h = self._axis_matrices(y.shape[1])
        _, p_w = self._axis_matrices(y.shape[2])
        x = torch.einsum("pj,njkc->npkc", p_h, y.float())
        return torch.einsum("qk,npkc->npqc", p_w, x)

    # -- public CEM ops ---------------------------------------------------

    def downsample(self, x: torch.Tensor) -> torch.Tensor:
        """H: (N, s*h, s*w, C) -> (N, h, w, C), circular boundary."""
        return self._matmul_downsample(x).to(x.dtype)

    def dt_satisfying_upscale(self, lr: torch.Tensor) -> torch.Tensor:
        """H^+ y = H^T (H H^T)^{-1} y — the consistent low-frequency upscale."""
        return self._matmul_upscale(lr).to(lr.dtype)

    def project(self, raw_hr: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
        """LF(lr) + null-space projection of raw_hr; H(result) == lr."""
        residual = lr.float() - self._matmul_downsample(raw_hr.float())
        return raw_hr + self._matmul_upscale(residual).to(raw_hr.dtype)

    def enforce_dt_on_image_pair(self, lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        """Project an arbitrary HR image to exact consistency with lr."""
        return self.project(hr, lr)

    def wrap(self, apply_fn):
        """``apply_fn(lr, z) -> raw_hr`` becomes ``wrapped(lr, z) ->
        projected_hr``; with ``pad_lr`` set, LR (and Z) are edge-padded first
        and the result cropped, hiding circular wraparound at the borders."""
        pad = int(self.conf.pad_lr)
        s = self.scale

        def edge_pad(t):
            return F.pad(t.permute(0, 3, 1, 2), (pad,) * 4, mode="replicate").permute(0, 2, 3, 1)

        def wrapped(lr, z=None):
            if pad:
                lr_p = edge_pad(lr)
                z_p = edge_pad(z) if z is not None else None
            else:
                lr_p, z_p = lr, z
            out = self.project(apply_fn(lr_p, z_p), lr_p)
            if pad:
                out = out[:, pad * s : -pad * s, pad * s : -pad * s, :]
            return out

        return wrapped


def make_cem(conf: CEMConf | None = None, device: str | torch.device = "cuda", **kwargs) -> CEM:
    return CEM(conf or CEMConf(**kwargs), device=device)
