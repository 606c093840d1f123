"""The yardstick's arithmetic for SwinIR (``configs/swinir_m_x4_real.json``),
beside the frozen ``roofline.py`` (whose ``generator_convs`` knows RRDBNet
and SRResNet): the published work of one forward, counted from the
configuration's shapes, its 3x3 convs as ``roofline.Conv`` sites, and the
bound of one window-attention launch.

Counts are per padded LR pixel (the LR reflect-padded to multiples of the
window, the upsampler run on the padded map, then cropped), as the network
runs. Multiply-adds per token: conv_first 9 in C; each Swin block qkv C 3C,
q k^T and attn v 2 x ws^2 C, proj C^2, fc1 and fc2 2 x C rC; each RSTB's
conv and conv_after_body 9 C^2; conv_before_upsample 9 C 64; the x4
nearest+conv upsampler 9 x 64^2 at 4 and 16 output pixels, conv_hr 9 x 64^2
and conv_last 9 x 64 x 3 at 16. At SwinIR-M (C 180, 36 blocks, r 2, ws 8):
13,665,132.

The attention launch (``window_attn_kernel``, one a block) is bound by
bytes: q, k and v read once and the output written once, in bf16, 2 x 4 C
bytes a token (1,440 at C 180) against 4 ws^2 C FLOP (46,080).
"""

from __future__ import annotations

from esr_bench import roofline

__all__ = ["attention_bound_s", "attention_bytes", "attention_flops", "generator_convs", "is_swinir", "macs_per_pixel",
           "model_flops", "padded"]

NUM_FEAT = 64


def _g(cfg: dict) -> dict:
    return cfg["network_G"]


def is_swinir(cfg: dict) -> bool:
    """Whether the configuration's generator is SwinIR (else ``roofline.py``'s)."""
    return _g(cfg)["which_model_G"].lower() == "swinir"


def padded(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """The LR size after the reflect pad to multiples of the window."""
    ws = _g(cfg)["window_size"]
    return -(-h // ws) * ws, -(-w // ws) * ws


def macs_per_pixel(cfg: dict) -> int:
    """Multiply-adds of one forward per padded LR pixel, as published."""
    g = _g(cfg)
    c, ws, cin = g["embed_dim"], g["window_size"], g["in_chans"]
    hidden = int(g["mlp_ratio"] * c)
    blocks = sum(g["depths"])
    block = c * 3 * c + 2 * ws * ws * c + c * c + 2 * c * hidden
    convs = 9 * cin * c + (len(g["depths"]) + 1) * 9 * c * c + 9 * c * NUM_FEAT
    up = 9 * NUM_FEAT * NUM_FEAT * (4 + 16 + 16) + 9 * NUM_FEAT * cin * 16
    return blocks * block + convs + up


def generator_convs(cfg: dict, n: int, h: int, w: int) -> list[roofline.Conv]:
    """Every 3x3 conv of one forward on an (n, h, w) LR batch, in order, at
    the padded size (``roofline.Conv``: all on ``conv_tc_kernel``; the x2
    stages in the 2x2 parity mode)."""
    g = _g(cfg)
    c, cin = g["embed_dim"], g["in_chans"]
    hp, wp = padded(cfg, h, w)
    out = [roofline._conv3("conv_first", n, hp, wp, cin, c)]
    out += [roofline._conv3(f"layers.{i}.conv", n, hp, wp, c, c) for i in range(len(g["depths"]))]
    out += [roofline._conv3("conv_after_body", n, hp, wp, c, c),
            roofline._conv3("conv_before_upsample", n, hp, wp, c, NUM_FEAT),
            roofline._parity("conv_up1", n, hp, wp, NUM_FEAT, NUM_FEAT),
            roofline._parity("conv_up2", n, 2 * hp, 2 * wp, NUM_FEAT, NUM_FEAT),
            roofline._conv3("conv_hr", n, 4 * hp, 4 * wp, NUM_FEAT, NUM_FEAT),
            roofline._conv3("conv_last", n, 4 * hp, 4 * wp, NUM_FEAT, cin)]
    return out


def model_flops(cfg: dict, n: int, h: int, w: int) -> float:
    """One forward's FLOPs (2 a multiply-add) on an (n, h, w) LR batch."""
    hp, wp = padded(cfg, h, w)
    return 2.0 * macs_per_pixel(cfg) * n * hp * wp


def attention_flops(cfg: dict, n: int, h: int, w: int) -> float:
    """One attention launch's FLOPs: q k^T and attn v, 2 ws^2 C each a token."""
    g = _g(cfg)
    hp, wp = padded(cfg, h, w)
    return 4.0 * g["window_size"] ** 2 * g["embed_dim"] * n * hp * wp


def attention_bytes(cfg: dict, n: int, h: int, w: int) -> float:
    """One attention launch's bytes: q, k, v in and the output out, bf16, once each."""
    hp, wp = padded(cfg, h, w)
    return 2.0 * 4 * _g(cfg)["embed_dim"] * n * hp * wp


def attention_bound_s(cfg: dict, n: int, h: int, w: int) -> float:
    """The least time one attention launch could take on the H100."""
    return roofline.bound_s(attention_flops(cfg, n, h, w), attention_bytes(cfg, n, h, w))
