"""Blind-SR benchmark (port of esr_tpu/scripts/blind_bench.py): how well the
adversarial kernel estimator recovers a known kernel, and what that buys
the CEM-wrapped SR.

For each (kernel, LR size) case:

1. a scale-invariant 1/f test image (KernelGAN's signal is cross-scale
   patch recurrence, which 1/f fields have by construction),
2. its LR by the true-kernel CEM operator,
3. ``estimate_kernel`` on that LR (the adversarial path ``--estimate_kernel``
   runs, no oracle),
4. the peak-aligned correlation of the estimate with the truth; SR PSNR
   under CEM with the estimated, the true and the (wrongly assumed) bicubic
   kernel, one generator for all three; and each SR's true-operator
   residual ``max|H_true(SR) - LR|`` (CEM is exactly consistent under its
   own kernel, so only the true operator shows a wrong kernel).

Run::

    python -m esr_tpu_torch.scripts.blind_bench [--iters 2000] [--sizes 64,96] \\
        [--json out.json] [--device cuda|cpu]

The generator is the port's seeded ``RRDBNet(nf 16, nb 2, gc 8)`` in f32 (on
CUDA: the f32 kernel, ``conv_f32_kernel``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

__all__ = ["aligned_corr", "gaussian_kernel", "main", "one_f_image", "run_case"]


def one_f_image(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """Scale-invariant (1/f amplitude spectrum) random field in [0,1]."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    amp = 1.0 / np.maximum(np.hypot(fy, fx), 1.0 / max(h, w))
    img = np.stack(
        [np.real(np.fft.ifft2(amp * np.exp(2j * np.pi * rng.random((h, w))))) for _ in range(channels)],
        axis=-1,
    )
    img -= img.min()
    img /= img.max() + 1e-12
    return img.astype(np.float32)


def gaussian_kernel(sup: int = 13, sx: float = 2.4, sy: float = 1.4, theta: float = 0.5) -> np.ndarray:
    """Anisotropic rotated gaussian — a typical real-world SR kernel."""
    idx = np.arange(sup) - (sup - 1) / 2.0
    yy, xx = np.meshgrid(idx, idx, indexing="ij")
    c, s = np.cos(theta), np.sin(theta)
    u, v = c * xx + s * yy, -s * xx + c * yy
    k = np.exp(-0.5 * ((u / sx) ** 2 + (v / sy) ** 2))
    return k / k.sum()


def aligned_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Peak normalized cross-correlation over all shifts (the estimate may sit
    a pixel or two off-centre: the subsample phase is a gauge freedom).
    Handles different supports."""
    from numpy.fft import fft2, ifft2

    n = a.shape[0] + b.shape[0]
    fa = fft2(a - a.mean(), (n, n))
    fb = fft2(b - b.mean(), (n, n))
    xc = np.real(ifft2(fa * np.conj(fb)))
    denom = np.linalg.norm(a - a.mean()) * np.linalg.norm(b - b.mean())
    return float(xc.max() / (denom + 1e-12))


def run_case(kernel_name: str, k_true, lr_size: int, iters: int, seed: int = 0, device="cuda") -> dict:
    import torch

    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.cem.kernelgan import conf_for_image, estimate_kernel
    from esr_tpu_torch.models.architecture import RRDBNet
    from esr_tpu_torch.ops.metrics import psnr_torch

    scale = 4
    hr = one_f_image(lr_size * scale, lr_size * scale, seed)
    cem_true = make_cem(CEMConf(scale=scale, kernel=tuple(map(tuple, k_true))), device=device)
    hr_t = torch.from_numpy(hr)[None].to(cem_true.device)
    lr_t = cem_true.downsample(hr_t).clamp(0.0, 1.0)
    lr = lr_t[0].cpu().numpy()

    conf = conf_for_image(lr.shape, scale, iters, seed=seed)
    t0 = time.perf_counter()
    k_est, metrics = estimate_kernel(lr, conf, device=device)
    secs = time.perf_counter() - t0
    corr = aligned_corr(k_est, np.asarray(k_true, np.float64))

    # one generator, three CEM kernels: PSNR differences isolate the kernel
    g = RRDBNet(nf=16, nb=2, gc=8, scale=scale, seed=seed).to(cem_true.device).eval()
    with torch.no_grad():
        raw = g(lr_t)
    out = {"kernel": kernel_name, "lr_size": lr_size, "iters": conf.iters, "corr": corr,
           "estimate_s": secs, "metrics": metrics}
    for label, k in (("est", k_est), ("true", None), ("bicubic", None)):
        cem = cem_true if label == "true" else make_cem(
            CEMConf(scale=scale, kernel=None if k is None else tuple(map(tuple, k))), device=device)
        with torch.no_grad():
            sr = cem.project(raw, lr_t)
            out[f"psnr_{label}"] = float(psnr_torch(sr.clamp(0, 1), hr_t, quantize=False))
            # self-consistency (the CEM guarantee: ~1e-6 for every label)
            out[f"self_res_{label}"] = float((cem.downsample(sr) - lr_t).abs().max())
            # true-operator consistency: what a wrong kernel breaks
            out[f"true_res_{label}"] = float((cem_true.downsample(sr) - lr_t).abs().max())
    return out


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--sizes", default="64,96")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default=None, help="write results to this path")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from esr_tpu_torch.cem.kernels import downsample_kernel_2d

    kernels = {"aniso_gauss": gaussian_kernel(), "bicubic_matlab": downsample_kernel_2d(4)[0]}
    rows = []
    for name, k in kernels.items():
        for size in (int(s) for s in args.sizes.split(",")):
            r = run_case(name, k, size, args.iters, args.seed, device=args.device)
            rows.append(r)
            print(f"{name:>15} lr={size:>4} corr={r['corr']:.3f} "
                  f"PSNR est/true/bicubic = {r['psnr_est']:.2f}/{r['psnr_true']:.2f}/{r['psnr_bicubic']:.2f} dB  "
                  f"true-residual est/bicubic = {r['true_res_est']:.2e}/{r['true_res_bicubic']:.2e}  "
                  f"estimate {r['estimate_s']:.2f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
