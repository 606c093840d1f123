"""Estimate the downsampling kernel of an LR image, KernelGAN-style (port of
esr_tpu/scripts/estimate_kernel.py)::

    python -m esr_tpu_torch.scripts.estimate_kernel --lr real_lr.png --scale 4 \\
        --iters 2000 --out kernel_x4.npy [--device cuda|cpu]

then point any train/test options file at it (``"kernel": "kernel_x4.npy"``):
LR synthesis, the CEM projection and exploration then run under the
estimated kernel. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["main"]


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--lr", required=True, help="LR image (png/jpg)")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--iters", type=int, default=2000)
    parser.add_argument("--g_input", type=int, default=64, help="G crop size (LR px)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", required=True, help="output .npy kernel path")
    parser.add_argument("--watchdog", type=float, default=None, metavar="SECONDS",
                        help="stall watchdog floor (default: on, 900 s; 0 disables)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from esr_tpu_torch.cem.kernelgan import KernelGANConf, estimate_kernel
    from esr_tpu_torch.data.util import read_img
    from esr_tpu_torch.utils.watchdog import arm_from_opt

    wd = arm_from_opt(args.watchdog, label="estimate_kernel")
    conf = KernelGANConf(scale=args.scale, iters=args.iters, g_input=args.g_input, seed=args.seed)

    def progress(done, total, metrics):
        print(f"[{done}/{total}] l_g {metrics['l_g']:.4f} l_d {metrics['l_d']:.4f} reg {metrics['reg']:.4f}",
              flush=True)
        if wd is not None:
            wd.beat()

    try:
        kernel, _ = estimate_kernel(read_img(args.lr), conf, progress=progress, device=args.device)
    finally:
        if wd is not None:
            wd.stop()
    np.save(args.out, kernel)
    peak = np.unravel_index(np.argmax(kernel), kernel.shape)
    print(f"saved {kernel.shape[0]}x{kernel.shape[1]} kernel to {args.out} "
          f"(peak at {peak}, sum {kernel.sum():.6f}) — use it as opt['kernel']")
    return kernel


if __name__ == "__main__":
    main()
