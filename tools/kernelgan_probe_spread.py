"""Run the KernelGAN supervised probe many times and print where it ends.

    python tools/kernelgan_probe_spread.py [--runs N] [--device cuda|cpu] [--perturb EPS]

The probe is tests/test_kernelgan.py's: the estimator on a seeded 96 x 96
noise image, its adversarial term replaced by L2 to the true anisotropic
Gaussian's downsample, 1000 iterations; its bar is an aligned correlation
above 0.88. Each run prints its aligned correlation and last ``l_g``.

- On the card (``--device cuda``) two passes of N runs: the supervised
  step with cuDNN's default algorithms (``full_f32`` without its
  ``deterministic`` flag), then the step as it stands (cuDNN's
  deterministic algorithms). The first pass shows the spread that the
  default weight-gradient atomics leave; the second must repeat one value.
- On the CPU (``--device cpu``) every run is bit-for-bit the same, so run i
  scales the image by ``1 + EPS * noise`` (seed i) to show how far a
  rounding-sized change moves the end point.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from esr_tpu_torch import device as device_mod  # noqa: E402
from esr_tpu_torch.cem import kernelgan  # noqa: E402
from esr_tpu_torch.scripts import blind_bench  # noqa: E402

PROBE = kernelgan.KernelGANConf(scale=4, g_kernels=(7, 5, 3, 1), g_channels=16, d_kernels=(5, 1, 1),
                                d_channels=16, g_input=32, iters=1000, lr_g=2e-3, w_centralized=0.1,
                                w_boundaries=0.1)


def probe(img: np.ndarray, device: str, default_cudnn: bool) -> tuple[float, float]:
    k_true = blind_bench.gaussian_kernel()
    kt = torch.tensor(k_true, dtype=torch.float32, device=device)[None, None]

    def loss_override(fake, g_in):  # the centred SAME oracle on G's phase
        full = F.conv2d(g_in.permute(0, 3, 1, 2), kt, padding=6).permute(0, 2, 3, 1)
        return torch.mean((fake - full[:, 6::4, 6::4][:, : fake.shape[1], : fake.shape[2]]) ** 2)

    if default_cudnn:  # the step without its deterministic flag: full f32 alone
        kernelgan.full_f32 = lambda deterministic=False: device_mod.full_f32()
    try:
        k, m = kernelgan.estimate_kernel(img, PROBE, loss_override=loss_override, device=device)
    finally:
        kernelgan.full_f32 = device_mod.full_f32
    return blind_bench.aligned_corr(k, k_true), m["l_g"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--perturb", type=float, default=1e-7, help="CPU only: relative image noise of run i >= 1")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    img = np.random.default_rng(2).random((96, 96)).astype(np.float32)
    passes = (("default cuDNN", True), ("deterministic cuDNN", False)) if a.device == "cuda" else (("cpu", False),)
    for label, default_cudnn in passes:
        corrs = []
        for i in range(a.runs):
            x = img
            if a.device == "cpu" and i:
                x = img * (1 + a.perturb * np.random.default_rng(100 + i).standard_normal(img.shape)).astype(np.float32)
            t0 = time.perf_counter()
            corr, l_g = probe(x, a.device, default_cudnn)
            corrs.append(corr)
            print(f"{label} run {i}: aligned corr {corr:.6f}, l_g {l_g:.6f}, {time.perf_counter() - t0:.2f} s",
                  flush=True)
        print(f"{label}: {a.runs} runs, aligned corr {min(corrs):.6f} - {max(corrs):.6f}, "
              f"{sum(c <= 0.88 for c in corrs)} at or below 0.88", flush=True)


if __name__ == "__main__":
    main()
