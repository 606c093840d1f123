"""Time the kernels alone: the conv kernel at the flagship forward's six conv
sites, at SRResNet's two 64 -> 256 upconvs and at 128 -> 128 in both modes,
and the fused RDB kernel; in bf16, or with ``--f32`` the f32 route (the
flagship's six sites, Cin 256 and the RDB as five f32 conv launches).

    python -m esr_tpu_torch.ops.cuda.conv_bench [--f32 | --widths | --forward]

Each conv site (B16, as ``chip_smoke.py`` phase 3) runs through
``conv_launch``, the RDB (B16 x 128 x 128 x 64, nf 64, gc 32) through
``rdb5c_launch``, each with its weight layout built once, as the forward
runs it: CUDA events around 20 back-to-back launches, median of 5 windows,
ms per launch. One line, ``BENCH [f32] card | site ms | ... | rdb5c ms``, so
that kernel versions built in turns on one card can be compared
(``chip_smoke.py`` phase 3 times the same sites beside their plain version,
library call and bound). ``--widths`` times the bf16 RDB at the other
widths of ``WIDTHS`` on B16 x 128 x 128 x nf instead (5 launches a window,
3 windows), ``--forward`` the CEM-wrapped flagship eval forward at B16 x LR
128 (``make_eval_forward``, seed-0 weights; 2 calls a window, 5 windows)
and one forward's launches.
Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from esr_tpu_torch.ops.cuda.kpack_conv import conv_kernel_weights, conv_launch
from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_kernel_weights, rdb5c_launch

# (site, input edge, Cin, Cout, ksize): the flagship's conv_first,
# trunk_conv, HRconv and conv_last in 3x3 mode and its two upsample convs in
# 2x2 mode; SRResNet x4's upconvs (3x3, Cout in four slices); 128 -> 128 (two
# K chunks, two slices) in both modes
SITES = (("conv_first", 128, 4, 64, 3), ("trunk_conv", 128, 64, 64, 3), ("HRconv", 512, 64, 64, 3),
         ("conv_last", 512, 64, 3, 3), ("upconv1", 128, 64, 64, 2), ("upconv2", 256, 64, 64, 2),
         ("sr_upconv1", 128, 64, 256, 3), ("sr_upconv2", 256, 64, 256, 3), ("wide128", 128, 128, 128, 3),
         ("wide128_up", 128, 128, 128, 2))
# the f32 route: the flagship's six sites and a Cin the earlier f32 kernel
# could not hold (256 -> 64 at 128)
F32_SITES = SITES[:6] + (("cin256", 128, 256, 64, 3),)
# (nf, gc) of the bf16 RDBs other than the flagship's 64 / 32: the JAX
# package's kernel test's width, and one width of each other instance
WIDTHS = ((16, 8), (32, 16), (128, 64))


def launch_ms(fn, reps: int = 20, windows: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def rdb_params(nf: int, gc: int, g: torch.Generator) -> dict:
    """Kaiming-scale RDB weights, zero biases, on the card."""
    params = {}
    for k in range(1, 6):
        cin, cout = nf + gc * (k - 1), nf if k == 5 else gc
        params[f"w{k}"] = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
        params[f"b{k}"] = torch.zeros(cout, device="cuda")
    return params


def bench_widths(g: torch.Generator) -> list[str]:
    out = []
    for nf, gc in WIDTHS:
        x = torch.randn(16, 128, 128, nf, device="cuda", generator=g).bfloat16()
        kw = rdb5c_kernel_weights(rdb_params(nf, gc, g), torch.bfloat16, x.device)
        out.append(f"rdb5c nf {nf} gc {gc} {launch_ms(lambda: rdb5c_launch(x, kw), reps=5, windows=3):.4f}")
        del x, kw
    return out


def bench_forward() -> list[str]:
    """ms per flagship forward, and one forward's launches (rdb5c / conv3x3 /
    upsample2x_conv3x3) counted after the timing."""
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.models import define_G, make_eval_forward
    from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv

    opt = {"network_G": {"nf": 64, "nb": 23, "gc": 32, "num_latent_channels": 1}, "scale": 4, "bf16": True}
    fwd = make_eval_forward(define_G(opt, device="cuda", seed=0), make_cem(CEMConf(scale=4), device="cuda"))
    lr = torch.rand(16, 128, 128, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    z = torch.zeros(16, 128, 128, 1, device="cuda")
    ms = launch_ms(lambda: fwd(lr, z), reps=2, windows=5)
    counters = (rdb_conv.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP)
    for c in counters:
        c.reset()
    fwd(lr, z)
    torch.cuda.synchronize()
    return [f"forward B16 LR128 {ms:.3f}", "launches " + " / ".join(str(c.count) for c in counters)]


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--f32", action="store_true", help="time the f32 route instead of the bf16 kernels")
    what.add_argument("--widths", action="store_true", help="time the bf16 RDB at the widths of WIDTHS")
    what.add_argument("--forward", action="store_true", help="time the flagship eval forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_bench: needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(0)
    if args.widths or args.forward:
        out = bench_widths(g) if args.widths else bench_forward()
        print(f"BENCH {torch.cuda.get_device_name(0)} | " + " | ".join(out), flush=True)
        return
    dtype = torch.float32 if args.f32 else torch.bfloat16
    out = []
    for site, s, cin, cout, ksize in F32_SITES if args.f32 else SITES:
        x = torch.randn(16, s, s, cin, device="cuda", generator=g).to(dtype)
        w = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
        kw = conv_kernel_weights(w, torch.zeros(cout, device="cuda"), dtype, x.device, ksize)
        out.append(f"{site} {launch_ms(lambda: conv_launch(x, kw, True)):.4f}")
        del x, kw
    x = torch.randn(16, 128, 128, 64, device="cuda", generator=g).to(dtype)
    kw = rdb5c_kernel_weights(rdb_params(64, 32, g), dtype, x.device)
    out.append(f"rdb5c {launch_ms(lambda: rdb5c_launch(x, kw)):.4f}")
    print(f"BENCH {'f32 ' * args.f32}{torch.cuda.get_device_name(0)} | " + " | ".join(out), flush=True)


if __name__ == "__main__":
    main()
