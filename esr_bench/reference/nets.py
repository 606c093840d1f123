"""The generators, written out from their papers, as functions of a state
dict with the reference torch keys (OIHW weights).

- RRDBNet (ESRGAN, Wang et al. 2018): ``conv_first``; ``nb`` RRDBs, each
  three dense blocks (conv k reads the concat of the block input and
  x_1..x_{k-1}, LeakyReLU 0.2 after convs 1-4, out = x + 0.2 x_5) and an
  outer ``x + 0.2 rdb3(rdb2(rdb1(x)))``; ``trunk_conv`` added to the trunk
  input; per x2 stage a nearest upsample then ``upconv`` + LeakyReLU;
  ``HRconv`` + LeakyReLU; ``conv_last``. The explorable fork concatenates
  the Z map to the LR input (``latent_input: first_layer``).
- SRResNet (MSRResNet, no BatchNorm): ``conv_first`` + LeakyReLU; ``nb``
  blocks ``x + conv2(relu(conv1(x)))``; ``trunk_conv`` added to the trunk
  input; per x2 stage ``upconv`` (nf -> 4 nf), pixel shuffle, LeakyReLU;
  ``HRconv`` + LeakyReLU; ``conv_last``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["exact", "generator", "generator_shapes"]

FP8_MAX = 448.0  # float8 e4m3's largest finite value
E5M2_MAX = 57344.0  # float8 e5m2's


@contextlib.contextmanager
def exact():
    """TF32 off in matmuls and cuDNN convs inside; the flags restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _stages(scale: int) -> int:
    if scale not in (2, 4, 8):
        raise ValueError(f"scale {scale}: the reference has x2 stages only")
    return {2: 1, 4: 2, 8: 3}[scale]


def generator_shapes(cfg: dict) -> dict[str, tuple[tuple, float]]:
    """``{key: (shape, gain)}`` of the generator of configuration ``cfg``:
    weights are Kaiming-normal (fan in) times ``gain``, biases take ``gain``
    0.01 (the benchmark's seeded weights; no released ones offline)."""
    g = cfg["network_G"]
    nf, nb, nz = g["nf"], g["nb"], g.get("num_latent_channels", 0)
    in_nc, out_nc = g["in_nc"], g["out_nc"]
    out: dict = {}

    def conv(name, cin, cout, gain=1.0):
        out[f"{name}.weight"] = ((cout, cin, 3, 3), gain)
        out[f"{name}.bias"] = ((cout,), 0.01)

    conv("conv_first", in_nc + nz, nf)
    if g["which_model_G"] == "RRDB_net":
        gc = g["gc"]
        for b in range(nb):
            for r in (1, 2, 3):
                for k in range(1, 6):
                    conv(f"RRDB_trunk.{b}.RDB{r}.conv{k}", nf + (k - 1) * gc, nf if k == 5 else gc, 0.1)
        up_out = nf
    elif g["which_model_G"] == "sr_resnet":
        for b in range(nb):
            conv(f"block{b}.conv1", nf, nf, 0.1)
            conv(f"block{b}.conv2", nf, nf, 0.1)
        up_out = 4 * nf
    else:
        raise ValueError(f"unknown generator {g['which_model_G']!r}")
    conv("trunk_conv", nf, nf, 0.1)
    for i in range(_stages(cfg["scale"])):
        conv(f"upconv{i + 1}", nf, up_out)
    conv("HRconv", nf, nf)
    conv("conv_last", nf, out_nc)
    return out


def _q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale, back in float32;
    the gradient passes straight through (autograd has none for the cast)."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return t + ((t.detach() / s).to(torch.float8_e4m3fn).float() * s - t.detach())


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to float8
    e5m2 with a per-tensor scale, as fp8 training does to a layer's output
    gradient before its backward products."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        s = g.abs().amax().clamp(min=1e-30) / E5M2_MAX
        return (g / s).to(torch.float8_e5m2).float() * s


def conv8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """The control's conv: input and weight in e4m3, its output gradient in e5m2."""
    return _GradE5M2.apply(F.conv2d(_q8(x), _q8(w), b, **kw))


def _conv(x: torch.Tensor, sd: dict, name: str, prec: str) -> torch.Tensor:
    w, b = sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float()
    if prec == "fp8":
        return conv8(x, w, b, padding=1)
    return F.conv2d(x, w, b, padding=1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _rdb(x: torch.Tensor, sd: dict, name: str, prec: str) -> torch.Tensor:
    feats = [x]
    for k in range(1, 5):
        feats.append(_lrelu(_conv(torch.cat(feats, 1), sd, f"{name}.conv{k}", prec)))
    return x + 0.2 * _conv(torch.cat(feats, 1), sd, f"{name}.conv5", prec)


def generator(sd: dict, cfg: dict, lr: torch.Tensor, z: torch.Tensor | None = None,
              prec: str = "f32") -> torch.Tensor:
    """The raw HR output (N, sH, sW, out_nc), float32, of NHWC ``lr`` (and
    ``z`` when the net has Z channels)."""
    g = cfg["network_G"]
    x = lr.float()
    if g.get("num_latent_channels", 0):
        x = torch.cat([x, z.float()], -1)
    x = x.permute(0, 3, 1, 2)
    rrdb = g["which_model_G"] == "RRDB_net"
    fea = _conv(x, sd, "conv_first", prec)
    if not rrdb:
        fea = _lrelu(fea)
    trunk = fea
    for b in range(g["nb"]):
        if rrdb:
            y = trunk
            for r in (1, 2, 3):
                y = _rdb(y, sd, f"RRDB_trunk.{b}.RDB{r}", prec)
            trunk = trunk + 0.2 * y
        else:
            trunk = trunk + _conv(F.relu(_conv(trunk, sd, f"block{b}.conv1", prec)), sd, f"block{b}.conv2", prec)
    fea = fea + _conv(trunk, sd, "trunk_conv", prec)
    for i in range(_stages(cfg["scale"])):
        if rrdb:
            fea = _lrelu(_conv(F.interpolate(fea, scale_factor=2, mode="nearest"), sd, f"upconv{i + 1}", prec))
        else:
            fea = _lrelu(F.pixel_shuffle(_conv(fea, sd, f"upconv{i + 1}", prec), 2))
    out = _conv(_lrelu(_conv(fea, sd, "HRconv", prec)), sd, "conv_last", prec)
    return out.permute(0, 2, 3, 1)
