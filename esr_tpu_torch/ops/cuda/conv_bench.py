"""Time the kernels alone: the conv kernel at the flagship forward's six conv
sites, at SRResNet's two 64 -> 256 upconvs and at 128 -> 128 in both modes,
and the fused RDB kernel; in bf16, or with ``--f32`` the f32 route (the
flagship's six sites, Cin 256 and the RDB as five f32 conv launches).

    python -m esr_tpu_torch.ops.cuda.conv_bench [--f32]

Each conv site (B16, as ``chip_smoke.py`` phase 3) runs through
``conv_launch``, the RDB (B16 x 128 x 128 x 64, nf 64, gc 32) through
``rdb5c_launch``, each with its weight layout built once, as the forward
runs it: CUDA events around 20 back-to-back launches, median of 5 windows,
ms per launch. One line, ``BENCH [f32] card | site ms | ... | rdb5c ms``, so
that kernel versions built in turns on one card can be compared
(``chip_smoke.py`` phase 3 times the same sites beside their plain version,
library call and bound). Needs an NVIDIA GPU.
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


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f32", action="store_true", help="time the f32 route instead of the bf16 kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_bench: needs an NVIDIA GPU")
    dtype = torch.float32 if args.f32 else torch.bfloat16
    g = torch.Generator("cuda").manual_seed(0)
    out = []
    for site, s, cin, cout, ksize in F32_SITES if args.f32 else SITES:
        x = torch.randn(16, s, s, cin, device="cuda", generator=g).to(dtype)
        w = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
        kw = conv_kernel_weights(w, torch.zeros(cout, device="cuda"), dtype, x.device, ksize)
        out.append(f"{site} {launch_ms(lambda: conv_launch(x, kw, True)):.4f}")
        del x, kw
    x = torch.randn(16, 128, 128, 64, device="cuda", generator=g).to(dtype)
    params = {}
    for k in range(1, 6):
        cin, cout = 64 + 32 * (k - 1), 64 if k == 5 else 32
        params[f"w{k}"] = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
        params[f"b{k}"] = torch.zeros(cout, device="cuda")
    kw = rdb5c_kernel_weights(params, dtype, x.device)
    out.append(f"rdb5c {launch_ms(lambda: rdb5c_launch(x, kw)):.4f}")
    print(f"BENCH {'f32 ' * args.f32}{torch.cuda.get_device_name(0)} | " + " | ".join(out), flush=True)


if __name__ == "__main__":
    main()
