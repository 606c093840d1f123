"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin Transformer",
ICCVW 2021, arXiv:2108.10257), written out from the paper and the released
``main_test_swinir.py``, as a function of a state dict with the released
keys.

The model is the real-world x4 "M" setting, ``upsampler='nearest+conv'``,
``resi_connection='1conv'``, ``img_range`` 1 (NCHW inside, NHWC at the
edges, float32; nothing of the port, of JAX or of the JAX package):

    x = reflect-pad lr to multiples of the window, x = (x - mean) * img_range
    f = conv_first(x); t = LN_patch(f)
    per RSTB l:  u = t
        per STB i (shift s = 0 for even i, window // 2 for odd):
            h = roll(LN1(u), -s), windows of ws x ws tokens, qkv = h Wqkv + b,
            q *= head_dim^-0.5, h = softmax(q k^T + Brel + M_s) v, h = h Wproj + b,
            windows back, roll(+s); u = u + h; u = u + fc2(GELU(fc1(LN2(u))))
        t = conv_l(u) + t
    f = conv_after_body(LN(t)) + f
    y = LeakyReLU_0.01(conv_before_upsample(f))
    y = lrelu_0.2(conv_up1(nearest2x(y))); y = lrelu_0.2(conv_up2(nearest2x(y)))
    out = (conv_last(lrelu_0.2(conv_hr(y))) / img_range + mean)[:, :sH, :sW]

Brel[h, i, j] = table[(yi - yj + ws - 1) (2 ws - 1) + xi - xj + ws - 1, h];
M_s[i, j] = -100 where tokens i and j of a shifted window lie in different
regions of the padded map (rows and columns cut at -ws and -s), else 0.
LayerNorm eps 1e-5; GELU with erf. A test-time forward has no dropout or
drop-path. The released rule that drops the shift when ``img_size`` is no
larger than the window does not apply (64 > 8) and is not written out.

``prec="fp8"`` is the control: e4m3 operands (per-tensor scales) for every
conv, every linear and both attention products, with the output gradients
of the convs and linears in e5m2, as ``nets.conv8`` does for the convs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esr_bench.reference.nets import _GradE5M2, _q8, conv8

__all__ = ["MEAN", "generator", "generator_shapes", "relative_bias", "shift_mask"]

MEAN = (0.4488, 0.4371, 0.4040)
NUM_FEAT = 64  # the 'nearest+conv' upsampler's width


def _dims(cfg: dict) -> tuple[int, list, list, int, int]:
    g = cfg["network_G"]
    hidden = int(g["mlp_ratio"] * g["embed_dim"])
    return g["embed_dim"], list(g["depths"]), list(g["num_heads"]), g["window_size"], hidden


def generator_shapes(cfg: dict) -> dict[str, tuple[tuple, float]]:
    """``{key: (shape, gain)}`` of the configuration's SwinIR, the released
    keys. The benchmark draws a 2-D or 4-D tensor Kaiming-normal (fan in)
    times ``gain`` and a 1-D one normal times ``gain``: the linears at 0.5
    (so each block's branches stay of the order of the residual stream), the
    bias tables at 2 (std 1.15: the bias moves the scores as much as q k^T
    does), the LayerNorm weights at 0.1 (the traffic adds 1), the biases at
    0.01."""
    g = cfg["network_G"]
    c, depths, heads, ws, hidden = _dims(cfg)
    out: dict = {}

    def conv(name, cin, cout):
        out[f"{name}.weight"] = ((cout, cin, 3, 3), 1.0)
        out[f"{name}.bias"] = ((cout,), 0.01)

    def lin(name, cin, cout):
        out[f"{name}.weight"] = ((cout, cin), 0.5)
        out[f"{name}.bias"] = ((cout,), 0.01)

    def norm(name):
        out[f"{name}.weight"] = ((c,), 0.1)
        out[f"{name}.bias"] = ((c,), 0.01)

    conv("conv_first", g["in_chans"], c)
    norm("patch_embed.norm")
    for layer, (depth, nh) in enumerate(zip(depths, heads)):
        for i in range(depth):
            b = f"layers.{layer}.residual_group.blocks.{i}"
            norm(f"{b}.norm1")
            out[f"{b}.attn.relative_position_bias_table"] = (((2 * ws - 1) ** 2, nh), 2.0)
            lin(f"{b}.attn.qkv", c, 3 * c)
            lin(f"{b}.attn.proj", c, c)
            norm(f"{b}.norm2")
            lin(f"{b}.mlp.fc1", c, hidden)
            lin(f"{b}.mlp.fc2", hidden, c)
        conv(f"layers.{layer}.conv", c, c)
    norm("norm")
    conv("conv_after_body", c, c)
    conv("conv_before_upsample.0", c, NUM_FEAT)
    conv("conv_up1", NUM_FEAT, NUM_FEAT)
    conv("conv_up2", NUM_FEAT, NUM_FEAT)
    conv("conv_hr", NUM_FEAT, NUM_FEAT)
    conv("conv_last", NUM_FEAT, g["in_chans"])  # num_out_ch = in_chans
    return out


def relative_bias(table: torch.Tensor, ws: int) -> torch.Tensor:
    """The dense (heads, ws^2, ws^2) relative position bias of a table
    ((2 ws - 1)^2, heads), indexed as the released model does."""
    yy, xx = torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")
    y, x = yy.flatten(), xx.flatten()
    index = (y[:, None] - y[None, :] + ws - 1) * (2 * ws - 1) + (x[:, None] - x[None, :] + ws - 1)
    return table[index.to(table.device)].permute(2, 0, 1)


def shift_mask(h: int, w: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """SwinIR's ``calculate_mask`` for an (h, w) map: (windows, ws^2, ws^2),
    -100 between tokens of different regions of the shifted map, else 0."""
    img = torch.zeros(h, w, device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img[hs, wsl] = cnt
            cnt += 1
    win = img.view(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, torch.tensor(-100.0, device=device), torch.tensor(0.0, device=device))


def _linear(x: torch.Tensor, sd: dict, name: str, prec: str) -> torch.Tensor:
    w, b = sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float()
    if prec == "fp8":
        return _GradE5M2.apply(F.linear(_q8(x), _q8(w), b))
    return F.linear(x, w, b)


def _conv(x: torch.Tensor, sd: dict, name: str, prec: str) -> torch.Tensor:
    w, b = sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float()
    return conv8(x, w, b, padding=1) if prec == "fp8" else F.conv2d(x, w, b, padding=1)


def _norm(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float(), 1e-5)


def _mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return _q8(a) @ _q8(b) if prec == "fp8" else a @ b


def _attention(x: torch.Tensor, sd: dict, name: str, nh: int, ws: int, mask, prec: str) -> torch.Tensor:
    """Window attention of (B_, N, C) window tokens (``WindowAttention.forward``)."""
    b_, n, c = x.shape
    qkv = _linear(x, sd, f"{name}.qkv", prec).reshape(b_, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // nh) ** -0.5, qkv[1], qkv[2]
    attn = _mm(q, k.transpose(-2, -1), prec)
    attn = attn + relative_bias(sd[f"{name}.relative_position_bias_table"].float(), ws)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b_ // nw, nw, nh, n, n) + mask[None, :, None]).view(-1, nh, n, n)
    x = _mm(attn.softmax(-1), v, prec).transpose(1, 2).reshape(b_, n, c)
    return _linear(x, sd, f"{name}.proj", prec)


def _block(x: torch.Tensor, sd: dict, name: str, nh: int, ws: int, shift: int, prec: str) -> torch.Tensor:
    """One Swin transformer block on (B, H, W, C) tokens."""
    b, h, w, c = x.shape
    y = _norm(x, sd, f"{name}.norm1")
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    win = y.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
    mask = shift_mask(h, w, ws, shift, x.device) if shift else None
    y = _attention(win, sd, f"{name}.attn", nh, ws, mask, prec)
    y = y.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y
    hid = F.gelu(_linear(_norm(x, sd, f"{name}.norm2"), sd, f"{name}.mlp.fc1", prec))
    return x + _linear(hid, sd, f"{name}.mlp.fc2", prec)


def generator(sd: dict, cfg: dict, lr: torch.Tensor, z: torch.Tensor | None = None,
              prec: str = "f32") -> torch.Tensor:
    """The raw HR output (N, sH, sW, in_chans), float32, of NHWC ``lr``
    (SwinIR has no Z input: ``z`` must be None)."""
    if z is not None:
        raise ValueError("SwinIR takes no Z map")
    g = cfg["network_G"]
    c, depths, heads, ws, _ = _dims(cfg)
    scale, rng = g["upscale"], float(g.get("img_range", 1.0))
    n, h, w, _ = lr.shape
    x = lr.float().permute(0, 3, 1, 2)
    x = F.pad(x, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), mode="reflect")
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) * rng
    f = _conv(x, sd, "conv_first", prec)
    t = _norm(f.permute(0, 2, 3, 1), sd, "patch_embed.norm")
    for layer, (depth, nh) in enumerate(zip(depths, heads)):
        u = t
        for i in range(depth):
            u = _block(u, sd, f"layers.{layer}.residual_group.blocks.{i}", nh, ws, 0 if i % 2 == 0 else ws // 2, prec)
        t = _conv(u.permute(0, 3, 1, 2), sd, f"layers.{layer}.conv", prec).permute(0, 2, 3, 1) + t
    f = _conv(_norm(t, sd, "norm").permute(0, 3, 1, 2), sd, "conv_after_body", prec) + f
    y = F.leaky_relu(_conv(f, sd, "conv_before_upsample.0", prec), 0.01)
    for name in ("conv_up1", "conv_up2")[: {2: 1, 4: 2}[scale]]:
        y = F.leaky_relu(_conv(F.interpolate(y, scale_factor=2, mode="nearest"), sd, name, prec), 0.2)
    y = _conv(F.leaky_relu(_conv(y, sd, "conv_hr", prec), 0.2), sd, "conv_last", prec)
    out = y / rng + mean
    return out[:, :, : h * scale, : w * scale].permute(0, 2, 3, 1)
