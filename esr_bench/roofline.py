"""The yardstick's arithmetic: the H100's published peaks, and the
operations and bytes of each generator conv, counted from the shapes of a
configuration.

The peaks and the counts are those of ``chip_smoke.py``'s kernel table,
kept here frozen so that a change to the program cannot move them. Peaks:
NVIDIA's H100 SXM data sheet, dense, at the full 700 W.

Two counts per conv:

- ``model_flops``: the network as published, for MFU. A x2 stage of
  RRDBNet is a nearest upsample then a 3x3 conv at the upsampled size
  (9 taps an output pixel). The GAN step adds the discriminator and
  VGG19 (``gan_step_flops``).
- ``kernel_flops`` and ``bytes``: what the kernel that runs the conv has to
  do, for its roofline. The port runs that x2 stage as four 2x2 parity
  convs on the LR grid (16 taps an input pixel, ``conv_tc_kernel`` with
  ``ksize`` 2), and each RDB as one ``rdb5c_tc_kernel`` launch. Bytes count
  each input read once and each output written once, in bf16, with the
  weights (bf16) and the biases (f32) of an RDB, as the kernel table does.
"""

from __future__ import annotations

from typing import NamedTuple

from esr_bench.reference.train import D_FEATS, VGG19

__all__ = ["PEAK_BF16_FLOPS", "PEAK_BYTES_PER_S", "Conv", "bound_s", "discriminator_flops", "gan_step_flops",
           "generator_convs", "model_flops", "vgg19_flops"]

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


class Conv(NamedTuple):
    site: str
    kernel: str  # "rdb5c_tc_kernel" or "conv_tc_kernel"
    model_flops: float
    kernel_flops: float
    bytes: float


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes, whichever bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _conv3(site: str, n: int, h: int, w: int, cin: int, cout: int) -> Conv:
    px = n * h * w
    f = 2.0 * 9 * cin * cout * px
    return Conv(site, "conv_tc_kernel", f, f, 2.0 * px * (cin + cout) + 2.0 * 9 * cin * cout)


def _parity(site: str, n: int, h: int, w: int, cin: int, cout: int) -> Conv:
    """Nearest x2 then 3x3 on the (n, h, w) input, run as four 2x2 convs."""
    px = n * h * w
    return Conv(site, "conv_tc_kernel", 2.0 * 9 * cin * cout * 4 * px, 2.0 * 16 * cin * cout * px,
                2.0 * px * (cin + 4 * cout) + 2.0 * 16 * cin * cout)


def _rdb(site: str, n: int, h: int, w: int, nf: int, gc: int) -> Conv:
    px = n * h * w
    macs = 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)
    weights = sum(9 * (nf + k * gc) * (nf if k == 4 else gc) for k in range(5))
    biases = 4 * gc + nf
    return Conv(site, "rdb5c_tc_kernel", 2.0 * macs * px, 2.0 * macs * px,
                2.0 * 2 * px * nf + 2.0 * weights + 4.0 * biases)


def generator_convs(cfg: dict, n: int, h: int, w: int) -> list[Conv]:
    """Every conv of one forward of the configuration's generator on an
    (n, h, w) LR batch, in order."""
    g = cfg["network_G"]
    nf, nb, nz = g["nf"], g["nb"], g.get("num_latent_channels", 0)
    stages = {2: 1, 4: 2, 8: 3}[cfg["scale"]]
    out = [_conv3("conv_first", n, h, w, g["in_nc"] + nz, nf)]
    rrdb = g["which_model_G"] == "RRDB_net"
    if rrdb:
        out += [_rdb(f"RRDB_trunk.{b}.RDB{r}", n, h, w, nf, g["gc"]) for b in range(nb) for r in (1, 2, 3)]
    else:
        out += [_conv3(f"block{b}.conv{k}", n, h, w, nf, nf) for b in range(nb) for k in (1, 2)]
    out.append(_conv3("trunk_conv", n, h, w, nf, nf))
    s = 1
    for i in range(stages):
        if rrdb:
            out.append(_parity(f"upconv{i + 1}", n, h * s, w * s, nf, nf))
        else:
            out.append(_conv3(f"upconv{i + 1}", n, h * s, w * s, nf, 4 * nf))
        s *= 2
    out += [_conv3("HRconv", n, h * s, w * s, nf, nf), _conv3("conv_last", n, h * s, w * s, nf, g["out_nc"])]
    return out


def model_flops(cfg: dict, n: int, h: int, w: int) -> float:
    """The generator's FLOPs (2 a multiply-add) as published, one forward."""
    return sum(c.model_flops for c in generator_convs(cfg, n, h, w))


def vgg19_flops(n: int, h: int, w: int, layer: int = 34) -> float:
    """VGG19's convs up to torchvision index ``layer``, one forward."""
    flops, idx, cin, s = 0.0, 0, 3, 1
    for feats, convs in VGG19:
        for _ in range(convs):
            if idx <= layer:
                flops += 2.0 * 9 * cin * feats * n * (h // s) * (w // s)
            idx, cin = idx + 2, feats
        idx, s = idx + 1, s * 2
    return flops


def discriminator_flops(n: int, h: int, w: int, nf: int = 64) -> float:
    """The VGG-128 discriminator (3x3 stride 1, 4x4 stride 2, alternating), one forward."""
    flops, cin, s = 0.0, 3, 1
    for j, f in enumerate(D_FEATS):
        cout, k = f * nf // 64, (3 if j % 2 == 0 else 4)
        s *= 1 + j % 2
        flops += 2.0 * k * k * cin * cout * n * (h // s) * (w // s)
        cin = cout
    return flops + 2.0 * n * (cin * (h // 32) * (w // 32) * 100 + 100)


def gan_step_flops(cfg: dict, n: int, hr: int) -> float:
    """A GAN step's model FLOPs, no recompute counted: G forward and
    backward (2x the forward); VGG19 on SR (forward and the input gradient)
    and on HR (forward); D on the doubled batch in G's step (forward and
    the input gradient) and in D's (forward and the weight gradient)."""
    lr = hr // cfg["scale"]
    g = model_flops(cfg, n, lr, lr)
    layer = cfg["train"]["feature_layer"]
    f = vgg19_flops(n, hr, hr, layer)
    d = discriminator_flops(2 * n, hr, hr, cfg["network_D"]["nf"])
    return 3 * g + 3 * f + 4 * d
