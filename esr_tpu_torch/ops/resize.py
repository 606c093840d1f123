"""MATLAB-faithful bicubic resampling matrices (host-side numpy).

Port of the matrix builders of ``esr_tpu/ops/resize.py``: MATLAB
``imresize`` semantics — separable cubic kernel with a = -0.5, antialiasing
(kernel stretched by 1/scale) when downscaling, symmetric (mirror) boundary
handling and per-output-pixel weight normalization — as one dense
``(out_len, in_len)`` matrix per axis. These matrices define the LR domain
the CEM projection is consistent with. ``imresize`` (tensors, any device) and
``imresize_np`` (host, f64) apply them: the eval datasets synthesise their LR
with ``imresize_np``.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from esr_tpu_torch.utils.profiler import annotate

__all__ = ["cubic_kernel", "imresize", "imresize_np", "resize_matrix"]


def cubic_kernel(x: np.ndarray) -> np.ndarray:
    """MATLAB's cubic interpolation kernel (Keys, a = -0.5)."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    x2 = x * x
    x3 = x2 * x
    return (1.5 * x3 - 2.5 * x2 + 1.0) * (x <= 1.0) + (
        -0.5 * x3 + 2.5 * x2 - 4.0 * x + 2.0
    ) * ((x > 1.0) & (x <= 2.0))


def _reflect_index(idx: np.ndarray, n: int) -> np.ndarray:
    """Map out-of-range 0-based indices into [0, n) with symmetric padding
    (mirror including the edge sample: -1 -> 0, n -> n-1, period 2n)."""
    period = 2 * n
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - 1 - idx, idx)


# Byte-bounded LRU for the dense f64 matrices, so that varied image sizes do
# not pin unbounded host memory.
_MAT_CACHE: collections.OrderedDict = collections.OrderedDict()
_MAT_CACHE_BUDGET = 128 * 2**20


def _resize_matrix_cached(in_len: int, out_len: int, antialias: bool) -> np.ndarray:
    key = (in_len, out_len, antialias)
    if key in _MAT_CACHE:
        _MAT_CACHE.move_to_end(key)
        return _MAT_CACHE[key]
    mat = _build_resize_matrix(in_len, out_len, antialias)
    _MAT_CACHE[key] = mat
    total = sum(m.nbytes for m in _MAT_CACHE.values())
    while total > _MAT_CACHE_BUDGET and len(_MAT_CACHE) > 1:
        _, old = _MAT_CACHE.popitem(last=False)
        total -= old.nbytes
    return mat


def _build_resize_matrix(in_len: int, out_len: int, antialias: bool) -> np.ndarray:
    scale = out_len / in_len
    base_width = 4.0  # cubic kernel support
    if scale < 1.0 and antialias:
        kernel_width = base_width / scale
    else:
        kernel_width = base_width

    # MATLAB 1-based output sample coordinates mapped into input space.
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    p = int(math.ceil(kernel_width)) + 2
    # (out_len, p) 1-based candidate source indices and kernel distances.
    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1.0 and antialias:
        weights = scale * cubic_kernel(dist * scale)
    else:
        weights = cubic_kernel(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    idx0 = _reflect_index((indices - 1.0).astype(np.int64), in_len)
    mat = np.zeros((out_len, in_len), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_len)[:, None], p, axis=1), idx0), weights)
    return mat


def resize_matrix(
    in_len: int, out_len: int, antialias: bool = True, dtype=np.float32
) -> np.ndarray:
    """Dense 1-D MATLAB-bicubic resampling matrix of shape (out_len, in_len):
    ``out = M @ in`` is one separable pass of MATLAB imresize."""
    return _resize_matrix_cached(int(in_len), int(out_len), bool(antialias)).astype(dtype)


def _out_shape(h: int, w: int, scale, out_shape) -> tuple[int, int]:
    if out_shape is not None:
        return int(out_shape[0]), int(out_shape[1])
    if scale is None:
        raise ValueError("either scale or out_shape must be given")
    # MATLAB: output size is ceil(in * scale)
    return int(math.ceil(h * scale)), int(math.ceil(w * scale))


def imresize(
    img: torch.Tensor,
    scale: float | None = None,
    out_shape: tuple[int, int] | None = None,
    antialias: bool = True,
) -> torch.Tensor:
    """MATLAB-bicubic resize of channel-last images on the tensor's device:
    (H, W), (H, W, C) or (N, H, W, C). Two f32 matmuls (keep TF32 off, as the
    JAX package keeps ``Precision.HIGHEST``: this op defines the LR domain)."""
    squeeze_hw = img.ndim == 2
    if squeeze_hw:
        img = img[..., None]
    h, w = img.shape[-3], img.shape[-2]
    out_h, out_w = _out_shape(h, w, scale, out_shape)
    mh, mw = resize_matrix(h, out_h, antialias), resize_matrix(w, out_w, antialias)
    with annotate("resize.upload", waits=True):  # copies from pageable memory: they wait for the stream
        mh, mw = torch.from_numpy(mh).to(img.device), torch.from_numpy(mw).to(img.device)
    x = torch.einsum("oh,...hwc->...owc", mh, img.float())
    x = torch.einsum("ow,...hwc->...hoc", mw, x)
    x = x.to(img.dtype) if img.is_floating_point() else x
    return x[..., 0] if squeeze_hw else x


def imresize_np(
    img: np.ndarray,
    scale: float | None = None,
    out_shape: tuple[int, int] | None = None,
    antialias: bool = True,
) -> np.ndarray:
    """Host (numpy, f64) twin of :func:`imresize` (and of the JAX package's
    ``imresize_np``); returns float32."""
    squeeze_hw = img.ndim == 2
    if squeeze_hw:
        img = img[..., None]
    h, w = img.shape[-3], img.shape[-2]
    out_h, out_w = _out_shape(h, w, scale, out_shape)
    mh = resize_matrix(h, out_h, antialias, dtype=np.float64)
    mw = resize_matrix(w, out_w, antialias, dtype=np.float64)
    # optimize=True: the contractions go to BLAS (the plain einsum loop takes
    # seconds on a 2K image)
    x = np.einsum("oh,...hwc->...owc", mh, img.astype(np.float64), optimize=True)
    x = np.einsum("ow,...hwc->...hoc", mw, x, optimize=True).astype(np.float32)
    return x[..., 0] if squeeze_hw else x
