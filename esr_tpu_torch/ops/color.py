"""Color-space conversions and tensor <-> image bridging (port of
esr_tpu/ops/color.py).

``rgb2ycbcr`` / ``bgr2ycbcr`` and ``tensor2img`` define the uint8 / Y-channel
domain PSNR and SSIM are computed in, so their rounding and coefficients are
the JAX package's: ITU-R BT.601 studio swing (MATLAB's rgb2ycbcr), round half
to even. ``to_uint8`` is ``tensor2img``'s conversion on the tensor's device,
bit-identical to it on f32 inputs. Layout is NHWC / RGB.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bgr2ycbcr", "img2tensor", "rgb2ycbcr", "tensor2img", "to_uint8", "ycbcr2rgb"]

# BT.601 full->studio swing RGB->YCbCr matrix, applied to [0,255] RGB.
_YCBCR_FROM_RGB = np.array(
    [
        [65.481, -37.797, 112.0],
        [128.553, -74.203, -93.786],
        [24.966, 112.0, -18.214],
    ],
    dtype=np.float64,
)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def _ycbcr_core(img: np.ndarray, matrix: np.ndarray, only_y: bool) -> np.ndarray:
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    if only_y:
        out = x @ matrix[:, 0] + _YCBCR_OFFSET[0]
    else:
        out = x @ matrix + _YCBCR_OFFSET
    out = out / 255.0
    if in_type == np.uint8:
        out = (out * 255.0).round().astype(np.uint8)
    else:
        out = out.astype(np.float32)
    return out


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """RGB (HWC, [0,1] float or uint8) -> YCbCr (or Y only), same value domain."""
    return _ycbcr_core(img, _YCBCR_FROM_RGB / 255.0, only_y)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR variant (cv2 channel order)."""
    return _ycbcr_core(img, (_YCBCR_FROM_RGB / 255.0)[::-1], only_y)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rgb2ycbcr` (full 3-channel), same value domain."""
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    inv = np.linalg.inv(_YCBCR_FROM_RGB / 255.0)
    out = (x - _YCBCR_OFFSET) @ inv
    out = out / 255.0
    if in_type == np.uint8:
        out = np.clip(out * 255.0, 0, 255).round().astype(np.uint8)
    else:
        out = out.astype(np.float32)
    return out


def tensor2img(tensor, out_type=np.uint8, min_max=(0.0, 1.0)) -> np.ndarray:
    """Tensor or array (..., H, W, C) float -> HWC uint8 RGB image.

    Clamp to min_max, scale, *round* (half to even) — not truncate — to
    uint8. Layout is NHWC/RGB."""
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.detach().float().cpu().numpy()
    x = np.asarray(tensor, dtype=np.float32)
    x = np.clip(x, min_max[0], min_max[1])
    x = (x - min_max[0]) / (min_max[1] - min_max[0])
    if x.ndim == 4:
        if x.shape[0] != 1:
            raise ValueError("tensor2img expects a single image")
        x = x[0]
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if out_type == np.uint8:
        return (x * 255.0).round().astype(np.uint8)
    return x


def to_uint8(x: torch.Tensor, min_max=(0.0, 1.0)) -> torch.Tensor:
    """:func:`tensor2img`'s uint8 conversion on ``x``'s device, so that eval
    fetches uint8 (a quarter of f32's bytes). Bit-identical to
    ``tensor2img`` on f32 inputs: the same f32 clip and scale,
    ``round(x * 255)`` half to even, then the cast. Layout is kept (no
    squeeze)."""
    x = x.float().clamp(min_max[0], min_max[1])
    x = (x - min_max[0]) / (min_max[1] - min_max[0])
    return torch.round(x * 255.0).to(torch.uint8)


def img2tensor(img: np.ndarray) -> np.ndarray:
    """HWC uint8/float image -> float32 [0,1] HWC array (layout unchanged)."""
    x = np.asarray(img)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    else:
        x = x.astype(np.float32)
    if x.ndim == 2:
        x = x[..., None]
    return x
