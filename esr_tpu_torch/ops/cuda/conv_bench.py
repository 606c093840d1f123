"""Time the bf16 conv kernel alone at the flagship forward's six conv sites.

    python -m esr_tpu_torch.ops.cuda.conv_bench

Each site (B16, as ``chip_smoke.py`` phase 3) runs through ``conv_launch``
with its weight image built once, as the forward runs it: CUDA events around
20 back-to-back launches, median of 5 windows, ms per launch. One line,
``BENCH card | site ms | ...``, so that kernel versions built in turns on
one card can be compared. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import statistics

import torch

from esr_tpu_torch.ops.cuda.kpack_conv import conv_kernel_weights, conv_launch

# (site, input edge, Cin, Cout, ksize): conv_first, trunk_conv, HRconv and
# conv_last in 3x3 mode, the two upsample convs in 2x2 mode
SITES = (("conv_first", 128, 4, 64, 3), ("trunk_conv", 128, 64, 64, 3), ("HRconv", 512, 64, 64, 3),
         ("conv_last", 512, 64, 3, 3), ("upconv1", 128, 64, 64, 2), ("upconv2", 256, 64, 64, 2))


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
    print(f"BENCH {torch.cuda.get_device_name(0)} | " + " | ".join(out), flush=True)


if __name__ == "__main__":
    main()
