"""Network interpolation, the ESRGAN recipe (port of
esr_tpu/scripts/net_interp.py, on torch ``.pth`` state dicts)::

    python -m esr_tpu_torch.scripts.net_interp --model_psnr psnr_G.pth --model_gan gan_G.pth \\
        --alpha 0.8 --out interp_08_G.pth

trades perceptual quality against fidelity by interpolating the parameters
of a PSNR-oriented generator and a GAN-trained one of the same
architecture, key by key: ``(1 - alpha) * theta_PSNR + alpha * theta_GAN``,
in f32. Either file may be in either reference key layout
(``normalize_rrdb_keys``); the result has the port's keys. Keys or shapes
that differ raise. Runs on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from esr_tpu_torch.models.networks import normalize_rrdb_keys

__all__ = ["interp_state_dicts", "main"]


def interp_state_dicts(a: dict, b: dict, alpha: float) -> dict:
    """``(1 - alpha) * a + alpha * b`` for every key, in f32; the two must
    hold the same keys with the same shapes."""
    if a.keys() != b.keys():
        raise ValueError(f"the state dicts' keys differ (only in the first: {sorted(a.keys() - b.keys())[:4]}, "
                         f"only in the second: {sorted(b.keys() - a.keys())[:4]}) — same architecture required")
    out = {}
    for k, va in a.items():
        vb = b[k]
        if va.shape != vb.shape:
            raise ValueError(f"{k}: shapes {tuple(va.shape)} and {tuple(vb.shape)} differ")
        out[k] = (1.0 - alpha) * va.float() + alpha * vb.float()
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model_psnr", required=True, help="PSNR-oriented G .pth (the alpha = 0 end)")
    parser.add_argument("--model_gan", required=True, help="GAN-trained G .pth (the alpha = 1 end)")
    parser.add_argument("--alpha", type=float, default=0.8)
    parser.add_argument("--out", required=True, help="output .pth")
    args = parser.parse_args(argv)
    a, b = (normalize_rrdb_keys(torch.load(p, map_location="cpu", weights_only=True))
            for p in (args.model_psnr, args.model_gan))
    torch.save(interp_state_dicts(a, b, args.alpha), args.out)
    print(f"saved alpha={args.alpha} interpolation to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
