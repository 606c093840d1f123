"""Time the bf16 kernels alone: the conv kernel at the flagship forward's six
conv sites, at SRResNet's two 64 -> 256 upconvs and at 128 -> 128 in both
modes, and the fused RDB kernel.

    python -m esr_tpu_torch.ops.cuda.conv_bench

Each conv site (B16, as ``chip_smoke.py`` phase 3) runs through
``conv_launch``, the RDB (B16 x 128 x 128 x 64, nf 64, gc 32) through
``rdb5c_launch``, each with its weight layout built once, as the forward
runs it: CUDA events around 20 back-to-back launches, median of 5 windows,
ms per launch. One line, ``BENCH card | site ms | ... | rdb5c ms``, so that
kernel versions built in turns on one card can be compared. Needs an NVIDIA
GPU.
"""

from __future__ import annotations

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
    if not torch.cuda.is_available():
        raise SystemExit("conv_bench: needs an NVIDIA GPU")
    g = torch.Generator("cuda").manual_seed(0)
    out = []
    for site, s, cin, cout, ksize in SITES:
        x = torch.randn(16, s, s, cin, device="cuda", generator=g).bfloat16()
        w = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
        kw = conv_kernel_weights(w, torch.zeros(cout, device="cuda"), torch.bfloat16, x.device, ksize)
        out.append(f"{site} {launch_ms(lambda: conv_launch(x, kw, True)):.4f}")
    x = torch.randn(16, 128, 128, 64, device="cuda", generator=g).bfloat16()
    params = {}
    for k in range(1, 6):
        cin, cout = 64 + 32 * (k - 1), 64 if k == 5 else 32
        params[f"w{k}"] = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
        params[f"b{k}"] = torch.zeros(cout, device="cuda")
    kw = rdb5c_kernel_weights(params, torch.bfloat16, x.device)
    out.append(f"rdb5c {launch_ms(lambda: rdb5c_launch(x, kw)):.4f}")
    print(f"BENCH {torch.cuda.get_device_name(0)} | " + " | ".join(out), flush=True)


if __name__ == "__main__":
    main()
