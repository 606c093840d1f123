"""PSNR / SSIM with the JAX package's evaluation semantics (port of
esr_tpu/ops/metrics.py).

``calculate_psnr`` / ``calculate_ssim`` take uint8-domain [0,255] images
(Y channel and a border crop of ``scale`` in the eval loop): PSNR =
20 log10(255 / sqrt(MSE)) in float64; SSIM with an 11x11 gaussian window
(sigma 1.5) over the 'valid' region, C1 = (0.01*255)^2, C2 = (0.03*255)^2,
via scipy's ``correlate2d`` as there. ``psnr_torch`` / ``ssim_torch`` are the
twins of ``psnr_jax`` / ``ssim_jax`` on the tensor's device (f32).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["calculate_psnr", "calculate_ssim", "crop_border", "psnr_torch", "ssim_torch"]


def crop_border(img: np.ndarray, border: int) -> np.ndarray:
    """Crop ``border`` pixels from each spatial edge."""
    if border == 0:
        return img
    return img[border:-border, border:-border, ...]


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR between two [0,255]-domain images (any shape), float64 math."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - (size - 1) / 2.0) ** 2) / (2.0 * sigma**2))
    return g / g.sum()


def _gaussian_window() -> np.ndarray:
    g = _gaussian_1d()
    return np.outer(g, g)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    from scipy.signal import correlate2d

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window()

    def filt(x):
        return correlate2d(x, window, mode="valid")

    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = filt(img1**2) - mu1_sq
    sigma2_sq = filt(img2**2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM between two [0,255]-domain HxW or HxWxC images (channel-averaged)."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if img1.shape != img2.shape:
        raise ValueError("input images must have the same dimensions")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 1:
            return _ssim_single(img1[..., 0], img2[..., 0])
        return float(np.mean([_ssim_single(img1[..., c], img2[..., c]) for c in range(img1.shape[2])]))
    raise ValueError("wrong input image dimensions")


def _to_uint8_domain(x: torch.Tensor, quantize: bool) -> torch.Tensor:
    x = x.float().clamp(0.0, 1.0) * 255.0
    return torch.round(x) if quantize else x


def psnr_torch(img1: torch.Tensor, img2: torch.Tensor, border: int = 0,
               quantize: bool = True, mean=torch.mean) -> torch.Tensor:
    """PSNR of [0,1] float images on their device, in the uint8 domain (with
    ``quantize``, :func:`calculate_psnr` of the ``tensor2img`` images to f32
    precision). (..., H, W, C); a 0-d tensor. ``mean``: the MSE's mean (a
    data-parallel step passes the global one)."""
    if border:
        img1 = img1[..., border:-border, border:-border, :]
        img2 = img2[..., border:-border, border:-border, :]
    a = _to_uint8_domain(img1, quantize)
    b = _to_uint8_domain(img2, quantize)
    mse = mean((a - b) ** 2)
    return 20.0 * torch.log10(255.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _valid_gaussian(n: int, device) -> torch.Tensor:
    """(n - 10, n) matrix of the 11-tap gaussian (sigma 1.5) over the 'valid'
    positions: one axis of the SSIM window, which is the outer product of
    two of these."""
    g = _gaussian_1d()
    m = np.zeros((n - 10, n))
    rows = np.arange(n - 10)
    for k in range(11):
        m[rows, rows + k] = g[k]
    return torch.as_tensor(m, dtype=torch.float32, device=device)


def ssim_torch(img1: torch.Tensor, img2: torch.Tensor, border: int = 0,
               quantize: bool = True) -> torch.Tensor:
    """SSIM (gaussian 11x11, sigma 1.5) of [0,1] float NHWC/HWC images on
    their device, averaged over pixels, channels and images. The window is
    applied as two f32 matmuls per axis (TF32 stays off for matmuls, as the
    JAX twin's ``Precision.HIGHEST``)."""
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    if border:
        img1 = img1[:, border:-border, border:-border, :]
        img2 = img2[:, border:-border, border:-border, :]
    # in [0,1] (SSIM is scale-invariant) for f32 conditioning
    a = _to_uint8_domain(img1, quantize) / 255.0
    b = _to_uint8_domain(img2, quantize) / 255.0
    gh = _valid_gaussian(a.shape[1], a.device)
    gw = _valid_gaussian(a.shape[2], a.device)

    def filt(x):
        return torch.einsum("jw,nhwc->nhjc", gw, torch.einsum("ih,nhwc->niwc", gh, x))

    c1, c2 = 0.01**2, 0.03**2
    mu1, mu2 = filt(a), filt(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = filt(a * a) - mu1_sq
    sigma2_sq = filt(b * b) - mu2_sq
    sigma12 = filt(a * b) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)
