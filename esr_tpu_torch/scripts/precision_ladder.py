"""Precision ladder: a generator checkpoint's eval error in each precision
against an f32 oracle (port of esr_tpu/scripts/precision_ladder.py)::

    python -m esr_tpu_torch.scripts.precision_ladder run [--ckpt G.pth] --out ladder.npz [--device cuda|cpu]
    python -m esr_tpu_torch.scripts.precision_ladder compare ladder.npz ladder.npz

``run`` forwards one deterministic 1/f ("natural spectrum") LR image (white
noise overstates bf16 error against natural images) through the raw
generator in each variant, all in one process, and saves the outputs to an
``.npz`` (one HWC f32 array per variant):

- ``bf16_kernels``: bf16 convs on the Hopper kernels (the eval path);
- ``f32_kernels``: f32 convs on the f32 kernels (``"bf16": false``);
- ``f32_plain``: the plain PyTorch convs in f32, TF32 off (the oracle);
- ``bf16_plain``: the plain PyTorch convs in bf16.

On the CPU the kernel variants run the plain versions. ``compare`` prints
rms / max / PSNR (over the nominal [0, 1] span) of every pair. The weights
are ``--ckpt`` (a G ``.pth``, either reference layout) or, without one,
the seeded flagship (RRDBNet nf 64, nb 23, gc 32, x4, one Z channel).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from esr_tpu_torch.device import full_f32

__all__ = ["VARIANTS", "main", "metrics", "one_over_f_image", "plain_forward", "run_variants"]

VARIANTS = ("bf16_kernels", "f32_kernels", "f32_plain", "bf16_plain")


def one_over_f_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Deterministic 1/f-spectrum RGB image in [0,1] (HWC f32)."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    amp = 1.0 / np.maximum(np.hypot(fy, fx), 1.0 / max(h, w))
    chans = []
    for _ in range(3):
        phase = np.exp(2j * np.pi * rng.random((h, w)))
        img = np.real(np.fft.ifft2(amp * phase))
        img = (img - img.min()) / (img.max() - img.min() + 1e-12)
        chans.append(img)
    return np.stack(chans, axis=-1).astype(np.float32)


def metrics(a: np.ndarray, b: np.ndarray) -> dict:
    """rms / max plus PSNR over the nominal [0, 1] span (a fixed span keeps
    rows of checkpoints whose output ranges differ comparable)."""
    d = a.astype(np.float64) - b.astype(np.float64)
    rms = float(np.sqrt(np.mean(d**2)))
    psnr = float(20 * np.log10(1.0 / max(rms, 1e-12)))
    return {"rms": rms, "max": float(np.abs(d).max()), "psnr_db": psnr}


def plain_forward(g, lr: torch.Tensor, z: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """RRDBNet ``g``'s forward on its own weights with every kernel replaced
    by its plain PyTorch version, computing in ``dtype``."""
    from esr_tpu_torch.models.architecture import _up_factors
    from esr_tpu_torch.models.blocks import upsample_nearest
    from esr_tpu_torch.ops.cuda.kpack_conv import conv3x3_reference
    from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_params_from_module, rdb5c_reference

    x = g._input(lr, z).to(dtype)

    def conv(m, t):
        return conv3x3_reference(t, m.hwio(), m.bias, m.act)

    fea = conv(g.conv_first, x)
    trunk = fea
    for i, blk in enumerate(g.RRDB_trunk):
        if g.all_layers:  # the 1x1 latent projection, in dtype
            proj = g.latent_proj[i]
            trunk = F.linear(torch.cat([trunk, x[..., 3:]], -1), proj.weight[:, :, 0, 0].to(dtype), proj.bias.to(dtype))
        out = trunk
        for rdb in (blk.RDB1, blk.RDB2, blk.RDB3):
            out = rdb5c_reference(out, rdb5c_params_from_module(rdb))
        trunk = trunk + 0.2 * out
    fea = fea + conv(g.trunk_conv, trunk)
    for i, r in enumerate(_up_factors(g.scale)):
        fea = conv(getattr(g, f"upconv{i + 1}"), upsample_nearest(fea, r))
    return conv(g.conv_last, conv(g.HRconv, fea)).float()


def _generator(state: dict | None, dtype: torch.dtype, device):
    from esr_tpu_torch.models import define_G
    from esr_tpu_torch.models.networks import rrdb_options_from_state

    net = rrdb_options_from_state(state) if state is not None else {"nf": 64, "nb": 23, "gc": 32,
                                                                       "num_latent_channels": 1}
    g = define_G({"network_G": net, "scale": 4, "bf16": dtype == torch.bfloat16}, device=device, seed=0)
    if state is not None:
        g.load_state_dict(state, strict=True)
    return g


@torch.no_grad()
def run_variants(state: dict | None, variants=VARIANTS, size=(64, 48), device="cuda") -> dict:
    """{variant: the raw generator's output (HWC f32) on the 1/f image of
    ``size`` (LR H, W) with Z = 0}; ``state``: a G state dict with the
    port's keys (the seeded flagship when None)."""
    bad = [v for v in variants if v not in VARIANTS]
    if bad:
        raise ValueError(f"unknown variants {bad}; choose from {VARIANTS}")
    h, w = size
    out = {}
    for v in variants:
        dtype = torch.bfloat16 if v.startswith("bf16") else torch.float32
        g = _generator(state, dtype, device)
        dev = next(g.parameters()).device
        lr = torch.from_numpy(one_over_f_image(h, w)[None]).to(dev)
        z = torch.zeros((1, h, w, g.num_latent_channels), device=dev) if g.num_latent_channels else None
        if v.endswith("_kernels"):
            g.prepare_kernels()
            y = g(lr, z)
        else:
            with full_f32():
                y = plain_forward(g, lr, z, dtype)
        out[v] = y[0].float().cpu().numpy()
        print(f"ran {v}: output range [{out[v].min():.3f}, {out[v].max():.3f}]", flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--ckpt", default=None, help="G .pth (default: the seeded flagship)")
    r.add_argument("--out", required=True, help="output .npz")
    r.add_argument("--size", default="64x48", help="LR HxW")
    r.add_argument("--variants", default=",".join(VARIANTS), help="comma list of " + "|".join(VARIANTS))
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    c = sub.add_parser("compare")
    c.add_argument("npz", nargs=2)
    args = parser.parse_args(argv)

    if args.cmd == "run":
        from esr_tpu_torch.models.networks import normalize_rrdb_keys

        h, w = (int(x) for x in args.size.split("x"))
        state = None
        if args.ckpt:
            state = normalize_rrdb_keys(torch.load(args.ckpt, map_location="cpu", weights_only=True))
        out = run_variants(state, args.variants.split(","), (h, w), args.device)
        np.savez(args.out, **out)
        print(f"saved {list(out)} -> {args.out}")
    else:
        a, b = (np.load(p) for p in args.npz)
        for ka in a.files:
            for kb in b.files:
                if (ka, args.npz[0]) >= (kb, args.npz[1]) and args.npz[0] == args.npz[1]:
                    continue
                m = metrics(a[ka], b[kb])
                print(f"{args.npz[0]}:{ka} vs {args.npz[1]}:{kb} — rms {m['rms']:.3e} max {m['max']:.3e} "
                      f"psnr {m['psnr_db']:.1f} dB")


if __name__ == "__main__":
    main()
