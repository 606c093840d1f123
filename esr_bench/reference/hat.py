"""HAT (Chen, Wang, Zhou, Qiao, Dong, "Activating More Pixels in Image
Super-Resolution Transformer", CVPR 2023, arXiv:2205.04437), written out
from the paper and the released ``hat/archs/hat_arch.py``, as a function of
a state dict with the released keys.

The model is the classical x4 one of ``options/test/HAT_SRx4_ImageNet-
pretrain.yml`` (``upsampler='pixelshuffle'``, ``resi_connection='1conv'``,
``img_range`` 1; NCHW inside, NHWC at the edges, float32; nothing of the
port, of JAX or of the JAX package):

    x = reflect-pad lr to multiples of the window, x = (x - mean) * img_range
    f = conv_first(x); t = LN_patch(f)
    per RHAG l:  u = t
        per HAB i (shift s = 0 for even i, window // 2 for odd):
            h = LN1(u)
            c = CAB(h) = CA(conv(GELU(conv(h)))),  CA(y) = y * sigmoid(W2 relu(W1 avgpool(y) + b1) + b2)
            a = roll(h, -s), windows of ws x ws tokens, qkv = a Wqkv + b, q *= head_dim^-0.5,
                a = softmax(q k^T + Brel + M_s) v, a = a Wproj + b, windows back, roll(+s)
            u = u + a + conv_scale * c;  u = u + fc2(GELU(fc1(LN2(u))))
        OCAB: h = LN1(u); q, k, v = split(h Wqkv + b); the ws x ws windows of q against
            nn.Unfold(wse, stride ws, padding (wse - ws) / 2) of the k and v maps (wse = ws +
            overlap_ratio ws), q *= head_dim^-0.5, a = softmax(q k^T + Boca) v, windows back;
            u = u + a Wproj + b;  u = u + fc2(GELU(fc1(LN2(u))))
        t = conv_l(u) + t
    f = conv_after_body(LN(t)) + f
    y = LeakyReLU_0.01(conv_before_upsample(f))
    y = pixel_shuffle2(upsample.0(y)); y = pixel_shuffle2(upsample.2(y))
    out = (conv_last(y) / img_range + mean)[:, :sH, :sW]

Brel and M_s are SwinIR's (``reference/swinir.py``): Brel[h, i, j] =
table[(yi - yj + ws - 1) (2 ws - 1) + xi - xj + ws - 1, h]; M_s -100 between
tokens of different regions of the shifted map. Boca[h, i, j] =
table[(ey - oy + ws - 1) (ws + wse - 1) + ex - ox + ws - 1, h] for query (oy,
ox) of the ws x ws window and key (ey, ex) of its wse x wse key window: the
index is the key's offset from the query, each coordinate shifted to start
at 0 (no released file is at hand to check the table's row order against).
A key outside the map is zero (the unfold's padding), so it scores Boca
alone. LayerNorm eps 1e-5; GELU with erf; a test-time forward has no
dropout or drop-path. Attention is computed a few windows at a time, so
that the scores of a whole DIV2K-sized batch fit on one card.

``prec="fp8"`` is the control: e4m3 operands (per-tensor scales, the
rounding of ``nets._q8``) for every conv (the channel attention's 1x1s
too), every linear and both attention products, as ``reference/swinir.py``
does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esr_bench.reference.nets import conv8
from esr_bench.reference.swinir import _linear, _mm, _norm, relative_bias, shift_mask

__all__ = ["MEAN", "generator", "generator_shapes", "oca_index"]

MEAN = (0.4488, 0.4371, 0.4040)
NUM_FEAT = 64  # the 'pixelshuffle' upsampler's width
WINDOWS = 256  # windows a step of the attention
# the seeded gains of the CAB (see generator_shapes)
CAB_OUT_GAIN, SQUEEZE_GAIN, EXCITE_GAIN = 10.0, 0.15, 2.0


def _dims(cfg: dict) -> dict:
    g = cfg["network_G"]
    c, ws = g["embed_dim"], g["window_size"]
    return {"c": c, "depths": list(g["depths"]), "heads": list(g["num_heads"]), "ws": ws,
            "wse": int(ws * g["overlap_ratio"]) + ws, "hidden": int(g["mlp_ratio"] * c),
            "mid": c // g["compress_ratio"], "sq": c // g["squeeze_factor"], "conv_scale": float(g["conv_scale"])}


def generator_shapes(cfg: dict) -> dict[str, tuple[tuple, float]]:
    """``{key: (shape, gain)}`` of the configuration's HAT, the released
    keys. The benchmark draws a 2-D or 4-D tensor Kaiming-normal (fan in)
    times ``gain`` and a 1-D one normal times ``gain``: as SwinIR's, the
    linears at 0.5, the bias tables at 2 (std 1.15 and 0.82: the bias moves
    the scores as much as q k^T does), the LayerNorm weights at 0.1 (the
    traffic adds 1), the biases at 0.01; the CAB's second conv at 10, so
    that ``conv_scale`` (0.01) times it moves the residual stream by tens of
    its bf16 steps rather than less than one, and the channel attention's
    1x1s at 0.15 and 2, so that its sigmoid spreads over (0, 1) instead of
    sitting at either end."""
    g = cfg["network_G"]
    d = _dims(cfg)
    c, ws, wse, hidden = d["c"], d["ws"], d["wse"], d["hidden"]
    out: dict = {}

    def conv(name, cin, cout, gain=1.0, k=3):
        out[f"{name}.weight"] = ((cout, cin, k, k), gain)
        out[f"{name}.bias"] = ((cout,), 0.01)

    def lin(name, cin, cout):
        out[f"{name}.weight"] = ((cout, cin), 0.5)
        out[f"{name}.bias"] = ((cout,), 0.01)

    def norm(name):
        out[f"{name}.weight"] = ((c,), 0.1)
        out[f"{name}.bias"] = ((c,), 0.01)

    conv("conv_first", g["in_chans"], c)
    norm("patch_embed.norm")
    for layer, (depth, nh) in enumerate(zip(d["depths"], d["heads"])):
        group = f"layers.{layer}.residual_group"
        for i in range(depth):
            b = f"{group}.blocks.{i}"
            norm(f"{b}.norm1")
            conv(f"{b}.conv_block.cab.0", c, d["mid"])
            conv(f"{b}.conv_block.cab.2", d["mid"], c, CAB_OUT_GAIN)
            conv(f"{b}.conv_block.cab.3.attention.1", c, d["sq"], SQUEEZE_GAIN, k=1)
            conv(f"{b}.conv_block.cab.3.attention.3", d["sq"], c, EXCITE_GAIN, k=1)
            out[f"{b}.attn.relative_position_bias_table"] = (((2 * ws - 1) ** 2, nh), 2.0)
            lin(f"{b}.attn.qkv", c, 3 * c)
            lin(f"{b}.attn.proj", c, c)
            norm(f"{b}.norm2")
            lin(f"{b}.mlp.fc1", c, hidden)
            lin(f"{b}.mlp.fc2", hidden, c)
        o = f"{group}.overlap_attn"
        norm(f"{o}.norm1")
        lin(f"{o}.qkv", c, 3 * c)
        out[f"{o}.relative_position_bias_table"] = (((ws + wse - 1) ** 2, nh), 2.0)
        lin(f"{o}.proj", c, c)
        norm(f"{o}.norm2")
        lin(f"{o}.mlp.fc1", c, hidden)
        lin(f"{o}.mlp.fc2", hidden, c)
        conv(f"layers.{layer}.conv", c, c)
    norm("norm")
    conv("conv_after_body", c, c)
    conv("conv_before_upsample.0", c, NUM_FEAT)
    conv("upsample.0", NUM_FEAT, 4 * NUM_FEAT)
    conv("upsample.2", NUM_FEAT, 4 * NUM_FEAT)
    conv("conv_last", NUM_FEAT, g["in_chans"])
    return out


def oca_index(ws: int, wse: int, device=None) -> torch.Tensor:
    """(ws^2, wse^2) table rows of the OCAB bias, as ``calculate_rpi_oca``
    builds them: the key window's coordinates less the query window's, each
    shifted by ws - 1, rows times (ws + wse - 1)."""
    ori = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    ext = torch.stack(torch.meshgrid(torch.arange(wse), torch.arange(wse), indexing="ij")).flatten(1)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0) + (ws - 1)  # ws^2, wse^2, 2
    return (rel[..., 0] * (ws + wse - 1) + rel[..., 1]).to(device)


def _conv(x: torch.Tensor, sd: dict, name: str, prec: str, padding: int = 1) -> torch.Tensor:
    w, b = sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float()
    return conv8(x, w, b, padding=padding) if prec == "fp8" else F.conv2d(x, w, b, padding=padding)


def _to_windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B nW, ws^2, C)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _from_windows(x: torch.Tensor, b: int, h: int, w: int, ws: int) -> torch.Tensor:
    c = x.shape[-1]
    return x.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _attend(q, k, v, nh: int, bias: torch.Tensor, mask, prec: str) -> torch.Tensor:
    """Multi-head softmax(q k^T scale + bias (+ mask)) v of (B_, Nq, C)
    queries and (B_, Nk, C) keys and values, a few windows at a time; mask
    (nW, Nq, Nk) repeats over the batch."""
    out = []
    for i in range(0, q.shape[0], WINDOWS):
        qs, ks, vs = q[i:i + WINDOWS], k[i:i + WINDOWS], v[i:i + WINDOWS]
        b_, nq, c = qs.shape
        d = c // nh
        qh = qs.reshape(b_, nq, nh, d).permute(0, 2, 1, 3) * d**-0.5
        kh = ks.reshape(b_, -1, nh, d).permute(0, 2, 1, 3)
        vh = vs.reshape(b_, -1, nh, d).permute(0, 2, 1, 3)
        attn = _mm(qh, kh.transpose(-2, -1), prec) + bias[None]
        if mask is not None:
            attn = attn + mask[torch.arange(i, i + b_, device=q.device) % mask.shape[0]][:, None]
        out.append(_mm(attn.softmax(-1), vh, prec).transpose(1, 2).reshape(b_, nq, c))
    return torch.cat(out)


def _cab(h: torch.Tensor, sd: dict, name: str, prec: str) -> torch.Tensor:
    """The channel attention block on NHWC ``h``, NHWC out."""
    y = _conv(F.gelu(_conv(h.permute(0, 3, 1, 2), sd, f"{name}.cab.0", prec)), sd, f"{name}.cab.2", prec)
    s = F.adaptive_avg_pool2d(y, 1)
    s = F.relu(_conv(s, sd, f"{name}.cab.3.attention.1", prec, padding=0))
    s = torch.sigmoid(_conv(s, sd, f"{name}.cab.3.attention.3", prec, padding=0))
    return (y * s).permute(0, 2, 3, 1)


def _mlp(x: torch.Tensor, sd: dict, name: str, prec: str) -> torch.Tensor:
    hid = F.gelu(_linear(_norm(x, sd, f"{name}.norm2"), sd, f"{name}.mlp.fc1", prec))
    return x + _linear(hid, sd, f"{name}.mlp.fc2", prec)


def _hab(x: torch.Tensor, sd: dict, name: str, nh: int, ws: int, shift: int, conv_scale: float,
         prec: str) -> torch.Tensor:
    """One hybrid attention block on (B, H, W, C) tokens."""
    b, h, w, c = x.shape
    y = _norm(x, sd, f"{name}.norm1")
    conv_x = _cab(y, sd, f"{name}.conv_block", prec)
    a = torch.roll(y, (-shift, -shift), (1, 2)) if shift else y
    qkv = _linear(_to_windows(a, ws), sd, f"{name}.attn.qkv", prec)
    bias = relative_bias(sd[f"{name}.attn.relative_position_bias_table"].float(), ws)
    mask = shift_mask(h, w, ws, shift, x.device) if shift else None
    a = _attend(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], nh, bias, mask, prec)
    a = _from_windows(_linear(a, sd, f"{name}.attn.proj", prec), b, h, w, ws)
    if shift:
        a = torch.roll(a, (shift, shift), (1, 2))
    return _mlp(x + a + conv_x * conv_scale, sd, name, prec)


def _ocab(x: torch.Tensor, sd: dict, name: str, nh: int, ws: int, wse: int, prec: str) -> torch.Tensor:
    """The overlapping cross-attention block on (B, H, W, C) tokens."""
    b, h, w, c = x.shape
    qkv = _linear(_norm(x, sd, f"{name}.norm1"), sd, f"{name}.qkv", prec)
    q = _to_windows(qkv[..., :c], ws)
    kv = torch.nn.Unfold(kernel_size=wse, stride=ws, padding=(wse - ws) // 2)(qkv[..., c:].permute(0, 3, 1, 2))
    kv = kv.view(b, 2, c, wse * wse, -1).permute(1, 0, 4, 3, 2).reshape(2, -1, wse * wse, c)
    table = sd[f"{name}.relative_position_bias_table"].float()
    bias = table[oca_index(ws, wse, x.device).flatten()].view(ws * ws, wse * wse, nh).permute(2, 0, 1)
    a = _from_windows(_attend(q, kv[0], kv[1], nh, bias, None, prec), b, h, w, ws)
    return _mlp(x + _linear(a, sd, f"{name}.proj", prec), sd, name, prec)


def generator(sd: dict, cfg: dict, lr: torch.Tensor, z: torch.Tensor | None = None,
              prec: str = "f32") -> torch.Tensor:
    """The raw HR output (N, sH, sW, in_chans), float32, of NHWC ``lr``
    (HAT has no Z input: ``z`` must be None)."""
    if z is not None:
        raise ValueError("HAT takes no Z map")
    g = cfg["network_G"]
    d = _dims(cfg)
    ws = d["ws"]
    scale, rng = g["upscale"], float(g.get("img_range", 1.0))
    n, h, w, _ = lr.shape
    x = F.pad(lr.float().permute(0, 3, 1, 2), (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), mode="reflect")
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    f = _conv((x - mean) * rng, sd, "conv_first", prec)
    t = _norm(f.permute(0, 2, 3, 1), sd, "patch_embed.norm")
    for layer, (depth, nh) in enumerate(zip(d["depths"], d["heads"])):
        group = f"layers.{layer}.residual_group"
        u = t
        for i in range(depth):
            u = _hab(u, sd, f"{group}.blocks.{i}", nh, ws, 0 if i % 2 == 0 else ws // 2, d["conv_scale"], prec)
        u = _ocab(u, sd, f"{group}.overlap_attn", nh, ws, d["wse"], prec)
        t = _conv(u.permute(0, 3, 1, 2), sd, f"layers.{layer}.conv", prec).permute(0, 2, 3, 1) + t
    f = _conv(_norm(t, sd, "norm").permute(0, 3, 1, 2), sd, "conv_after_body", prec) + f
    y = F.leaky_relu(_conv(f, sd, "conv_before_upsample.0", prec), 0.01)
    y = F.pixel_shuffle(_conv(y, sd, "upsample.0", prec), 2)
    y = F.pixel_shuffle(_conv(y, sd, "upsample.2", prec), 2)
    out = _conv(y, sd, "conv_last", prec) / rng + mean
    return out[:, :, : h * scale, : w * scale].permute(0, 2, 3, 1)

