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

A non-separable (2-D) kernel takes the ``fft`` mode (``auto``'s choice) or
the ``filter`` mode. H is then a wrap-padded depthwise strided correlation
with the 2-D kernel; H^T is written out as its exact adjoint (the transposed
conv, then the wrap padding folded back circularly), where the JAX package
derives it with ``jax.linear_transpose``. ``fft`` applies (H H^T)^{-1}
exactly on the LR grid (one complex64 fft2/ifft2 pair, eps magnitude
floor); ``filter`` as a truncated spatial inverse filter (a wrap-padded
depthwise conv). These convs run in full f32 whatever the caller's cuDNN
TF32 setting (the JAX package asks for ``Precision.HIGHEST``): TF32 is off
inside them and restored after.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from esr_tpu_torch.cem.kernels import bicubic_downsample_kernel_1d, downsample_kernel_2d, lr_autocorrelation
from esr_tpu_torch.device import full_f32, resolve_device

__all__ = ["CEMConf", "CEM", "make_cem"]


def _wrap_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of an axis of length ``n`` wrap-padded by ``lo`` and ``hi``."""
    return (torch.arange(-lo, n + hi, device=device) % n)


def _depthwise(x: torch.Tensor, k2d: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """VALID depthwise correlation of NHWC ``x`` with one 2-D kernel for every
    channel, in ``x.dtype`` and full f32."""
    c = x.shape[-1]
    w = k2d.to(x.dtype)[None, None].expand(c, 1, *k2d.shape)
    with full_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, groups=c)
    return y.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class CEMConf:
    scale: int = 4
    kernel: tuple | None = None  # optional custom 1-D/2-D kernel (nested tuples)
    eps: float = 1e-7  # magnitude floor for the frequency-domain inverse
    pad_lr: int = 0  # replicate pre-padding (LR pixels) to hide wraparound
    inv_mode: str = "auto"  # 'auto' | 'matmul' | 'fft' | 'filter'
    # auto -> 'matmul' for separable kernels, else 'fft'
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
        self._k2d = torch.as_tensor(k2d, dtype=torch.float32, device=self.device)
        self._q, self._q_center = lr_autocorrelation(k2d, s)
        self._inv_spatial = None
        if conf.inv_mode == "filter":
            self._inv_spatial = torch.as_tensor(self.inv_hht_spatial_filter(conf.inv_filter_support),
                                                device=self.device)
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
        if mode not in ("matmul", "fft", "filter"):
            raise ValueError(f"unknown inv_mode {conf.inv_mode!r}")
        if mode == "matmul" and self._k1 is None:
            raise ValueError("inv_mode='matmul' requires a separable kernel")
        self._mode = mode
        self._mat_cache: dict = {}
        self._freq_cache: dict = {}

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

    # -- H and H^T for the non-separable modes -----------------------------

    def _pads(self) -> tuple[tuple[int, int], tuple[int, int]]:
        """Wrap padding (left, right) per axis that makes H's strided VALID
        correlation start at ``rel``."""
        s = self.scale
        (kh, kw), (rel_h, rel_w) = self.k2d.shape, self.rel
        return ((max(0, -rel_h), max(0, rel_h + kh - s)), (max(0, -rel_w), max(0, rel_w + kw - s)))

    def downsample(self, x: torch.Tensor) -> torch.Tensor:
        """H: (N, s*h, s*w, C) -> (N, h, w, C), circular boundary.

        y[j] = sum_i x[(j*s + rel + i) mod n] k[i] per axis. Matmul mode: two
        per-axis contractions; otherwise a wrap pad, then the depthwise
        strided correlation with the 2-D kernel, in ``x.dtype``."""
        if self._mode == "matmul":
            return self._matmul_downsample(x).to(x.dtype)
        (ph, pw), (_, h, w, _) = self._pads(), x.shape
        xp = x.index_select(1, _wrap_index(h, *ph, x.device)).index_select(2, _wrap_index(w, *pw, x.device))
        return _depthwise(xp, self._k2d, self.scale)

    def upsample_transpose(self, y: torch.Tensor, hr_shape: tuple) -> torch.Tensor:
        """H^T: the exact adjoint of :meth:`downsample` (``hr_shape`` = the
        shape of H's input): the transposed depthwise conv with stride s onto
        the wrap-padded grid, then each padded row and column added back onto
        the one it wraps."""
        if self._mode == "matmul":
            a_h, _ = self._axis_matrices(y.shape[1])
            a_w, _ = self._axis_matrices(y.shape[2])
            x = torch.einsum("jh,njkc->nhkc", a_h, y.float())
            return torch.einsum("kw,nhkc->nhwc", a_w, x).to(y.dtype)
        s, (ph, pw) = self.scale, self._pads()
        n, h, w, c = hr_shape
        kh, kw = self.k2d.shape
        lh, lw = h + sum(ph), w + sum(pw)
        # the rows and columns of the padded grid that H's last window leaves unread
        extra = (lh - ((y.shape[1] - 1) * s + kh), lw - ((y.shape[2] - 1) * s + kw))
        wt = self._k2d.to(y.dtype)[None, None].expand(c, 1, kh, kw)
        with full_f32():
            xp = F.conv_transpose2d(y.permute(0, 3, 1, 2), wt, stride=s, groups=c, output_padding=extra)
        xp = xp.permute(0, 2, 3, 1)
        out = xp.new_zeros((n, h, lw, c)).index_add_(1, _wrap_index(h, *ph, y.device), xp)
        return out.new_zeros((n, h, w, c)).index_add_(2, _wrap_index(w, *pw, y.device), out)

    # -- (H H^T)^{-1} ------------------------------------------------------

    def _q_on_grid(self, h: int, w: int) -> np.ndarray:
        """The LR autocorrelation kernel (H H^T) embedded circularly on an
        (h, w) grid, lag 0 at the origin (f64)."""
        q = np.zeros((h, w))
        qh, qw = self._q.shape
        ch, cw = self._q_center
        for i in range(qh):
            for j in range(qw):
                q[(i - ch) % h, (j - cw) % w] += self._q[i, j]
        return q

    def _q_freq(self, h: int, w: int) -> torch.Tensor:
        """The eps-floored FFT of the LR autocorrelation kernel embedded on an
        (h, w) grid, complex64 on the device (cached per LR shape)."""
        if (h, w) in self._freq_cache:
            return self._freq_cache[(h, w)]
        fq = torch.as_tensor(np.fft.fft2(self._q_on_grid(h, w)).astype(np.complex64), device=self.device)
        # eps floor on the magnitude, as the JAX package computes it in complex64
        mag = fq.abs()
        eps = torch.tensor(self.conf.eps, dtype=mag.dtype, device=mag.device)
        fq_safe = torch.polar(torch.where(mag < eps, eps, mag), fq.angle())
        self._freq_cache[(h, w)] = fq_safe
        return fq_safe

    def apply_inv_hht(self, y: torch.Tensor) -> torch.Tensor:
        """(H H^T)^{-1} y on the LR grid: ``fft``, the exact circular inverse
        (eps floor); ``filter``, the truncated spatial inverse filter as a
        wrap-padded depthwise conv."""
        if self._inv_spatial is not None:
            r = self._inv_spatial.shape[0] // 2
            _, h, w, _ = y.shape
            yp = y.index_select(1, _wrap_index(h, r, r, y.device)).index_select(2, _wrap_index(w, r, r, y.device))
            return _depthwise(yp, self._inv_spatial)
        fq = self._q_freq(y.shape[1], y.shape[2])
        yf = torch.fft.fft2(y.float(), dim=(1, 2))
        return torch.fft.ifft2(yf / fq[None, :, :, None], dim=(1, 2)).real.to(y.dtype)

    def inv_hht_spatial_filter(self, support: int | None = None) -> np.ndarray:
        """Truncated spatial inverse filter of (H H^T), (support, support) f32:
        the exact inverse on a 4 x support grid, centred and cut."""
        support = support or self.conf.inv_filter_support
        n = 4 * support
        fq = np.fft.fft2(self._q_on_grid(n, n))
        mag = np.abs(fq)
        fq_safe = np.where(mag < self.conf.eps, self.conf.eps, mag) * np.exp(1j * np.angle(fq))
        inv = np.fft.fftshift(np.real(np.fft.ifft2(1.0 / fq_safe)))
        c, r = n // 2, support // 2
        return inv[c - r : c + r + 1, c - r : c + r + 1].astype(np.float32)

    # -- public CEM ops ---------------------------------------------------

    def dt_satisfying_upscale(self, lr: torch.Tensor) -> torch.Tensor:
        """H^+ y = H^T (H H^T)^{-1} y — the consistent low-frequency upscale."""
        if self._mode == "matmul":
            return self._matmul_upscale(lr).to(lr.dtype)
        n, h, w, c = lr.shape
        return self.upsample_transpose(self.apply_inv_hht(lr), (n, h * self.scale, w * self.scale, c))

    def project(self, raw_hr: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
        """LF(lr) + null-space projection of raw_hr; H(result) == lr."""
        if self._mode == "matmul":
            residual = lr.float() - self._matmul_downsample(raw_hr.float())
            return raw_hr + self._matmul_upscale(residual).to(raw_hr.dtype)
        residual = lr.float() - self.downsample(raw_hr.float())
        n, h, w, c = lr.shape
        hr_shape = (n, h * self.scale, w * self.scale, c)
        return raw_hr + self.upsample_transpose(self.apply_inv_hht(residual), hr_shape).to(raw_hr.dtype)

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
