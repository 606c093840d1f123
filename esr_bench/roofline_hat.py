"""The yardstick's arithmetic for HAT (``configs/hat_srx4_imagenet.json``),
beside the frozen ``roofline.py`` and ``roofline_swinir.py``: the published
work of one forward, counted from the configuration's shapes, its 3x3 convs
as ``roofline.Conv`` sites, and the bound of each launch HAT adds (the HAB
and OCAB attentions, the channel attention).

Counts are per padded LR pixel (the LR reflect-padded to multiples of the
window, 16, the upsampler run on the padded map, then cropped), as the
network runs. Multiply-adds per token, C the embedding, r the MLP ratio:

- each of the HABs and OCABs' linears: qkv C 3C, proj C^2, fc1 and fc2 2 x C rC;
- each HAB's CAB convs 9 C (C / compress) twice (its channel attention's
  1x1s act on one pooled value an image and channel: not counted a pixel);
- each HAB's attention q k^T and attn v, 2 x ws^2 C; each OCAB's, 2 x wse^2 C;
- conv_first 9 in C; each RHAG's conv and conv_after_body 9 C^2;
  conv_before_upsample 9 C 64; the x4 pixelshuffle upsampler 9 x 64 x 256
  at 1 and 4 output pixels; conv_last 9 x 64 x 3 at 16.

At the published x4 model (C 180, 6 RHAGs of 6 HABs and an OCAB, r 2, ws 16,
wse 24, compress 3): 25,361,388.

Bounds (``roofline.bound_s``: FLOPs over the bf16 peak or bytes over the
memory's, whichever is longer): an attention launch reads q, k, v once and
writes its output once in bf16, 2 x 4 C bytes a token, against 4 N C FLOP
(N its keys); a channel attention needs the CAB's output and the block's
input read once and the residual written once, 2 x 3 C bytes a token (a
design that reads the CAB's output twice, once to pool and once to scale,
pays the second read above the bound), against its 3 C FLOP.
"""

from __future__ import annotations

from esr_bench import roofline

__all__ = ["attention_bound_s", "attention_bytes", "attention_flops", "channel_attn_bound_s", "generator_convs",
           "key_window", "macs_per_pixel", "model_flops", "padded"]

NUM_FEAT = 64


def _g(cfg: dict) -> dict:
    return cfg["network_G"]


def key_window(cfg: dict) -> int:
    """The OCAB's key window edge, ws + overlap_ratio ws."""
    g = _g(cfg)
    return int(g["window_size"] * g["overlap_ratio"]) + g["window_size"]


def padded(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """The LR size after the reflect pad to multiples of the window."""
    ws = _g(cfg)["window_size"]
    return -(-h // ws) * ws, -(-w // ws) * ws


def _tokens(cfg: dict, n: int, h: int, w: int) -> float:
    hp, wp = padded(cfg, h, w)
    return float(n * hp * wp)


def macs_per_pixel(cfg: dict) -> int:
    """Multiply-adds of one forward per padded LR pixel, as published."""
    g = _g(cfg)
    c, ws, cin = g["embed_dim"], g["window_size"], g["in_chans"]
    hidden, mid, wse = int(g["mlp_ratio"] * c), c // g["compress_ratio"], key_window(cfg)
    habs, groups = sum(g["depths"]), len(g["depths"])
    linears = c * 3 * c + c * c + 2 * c * hidden
    hab = linears + 2 * 9 * c * mid + 2 * ws * ws * c
    ocab = linears + 2 * wse * wse * c
    convs = 9 * cin * c + (groups + 1) * 9 * c * c + 9 * c * NUM_FEAT
    up = 9 * NUM_FEAT * 4 * NUM_FEAT * (1 + 4) + 9 * NUM_FEAT * cin * 16
    return habs * hab + groups * ocab + convs + up


def model_flops(cfg: dict, n: int, h: int, w: int) -> float:
    """One forward's FLOPs (2 a multiply-add) on an (n, h, w) LR batch."""
    return 2.0 * macs_per_pixel(cfg) * _tokens(cfg, n, h, w)


def generator_convs(cfg: dict, n: int, h: int, w: int) -> list[roofline.Conv]:
    """Every 3x3 conv of one forward on an (n, h, w) LR batch, in order, at
    the padded size, all on ``conv_tc_kernel`` (the CABs' first as
    ``conv_tc_kernel_gelu``), counted at their published widths (the
    kernel's Cout padding to slices of 64 is not work)."""
    g = _g(cfg)
    c, cin, mid = g["embed_dim"], g["in_chans"], g["embed_dim"] // g["compress_ratio"]
    hp, wp = padded(cfg, h, w)
    out = [roofline._conv3("conv_first", n, hp, wp, cin, c)]
    for layer, depth in enumerate(g["depths"]):
        for i in range(depth):
            b = f"layers.{layer}.residual_group.blocks.{i}.conv_block"
            out += [roofline._conv3(f"{b}.cab.0", n, hp, wp, c, mid), roofline._conv3(f"{b}.cab.2", n, hp, wp, mid, c)]
        out.append(roofline._conv3(f"layers.{layer}.conv", n, hp, wp, c, c))
    out += [roofline._conv3("conv_after_body", n, hp, wp, c, c),
            roofline._conv3("conv_before_upsample.0", n, hp, wp, c, NUM_FEAT),
            roofline._conv3("upsample.0", n, hp, wp, NUM_FEAT, 4 * NUM_FEAT),
            roofline._conv3("upsample.2", n, 2 * hp, 2 * wp, NUM_FEAT, 4 * NUM_FEAT),
            roofline._conv3("conv_last", n, 4 * hp, 4 * wp, NUM_FEAT, cin)]
    return out


def attention_flops(cfg: dict, n: int, h: int, w: int, keys: int) -> float:
    """One attention launch's FLOPs with ``keys`` keys a query: q k^T and attn v, 2 keys C each a token."""
    return 4.0 * keys * _g(cfg)["embed_dim"] * _tokens(cfg, n, h, w)


def attention_bytes(cfg: dict, n: int, h: int, w: int) -> float:
    """One attention launch's bytes: q, k, v in and the output out, bf16, once each."""
    return 2.0 * 4 * _g(cfg)["embed_dim"] * _tokens(cfg, n, h, w)


def attention_bound_s(cfg: dict, n: int, h: int, w: int, oca: bool) -> float:
    """The least time one HAB (``oca`` False: ws^2 keys) or OCAB (wse^2 keys)
    attention launch could take on the H100."""
    keys = key_window(cfg) ** 2 if oca else _g(cfg)["window_size"] ** 2
    return roofline.bound_s(attention_flops(cfg, n, h, w, keys), attention_bytes(cfg, n, h, w))


def channel_attn_bound_s(cfg: dict, n: int, h: int, w: int) -> float:
    """The least time one channel attention (pool, squeeze, scale and the
    residual) could take on the H100: 2 x 3 C bytes and 3 C FLOP a token."""
    c, tokens = _g(cfg)["embed_dim"], _tokens(cfg, n, h, w)
    return roofline.bound_s(3.0 * c * tokens, 2.0 * 3 * c * tokens)
