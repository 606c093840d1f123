"""Shifted-window multi-head self-attention (a Swin transformer block's
attention, SwinIR's ``WindowAttention`` with its block's roll and window
partition): the ``window_attn`` CUDA kernel and its plain PyTorch version.

Replaces no TPU kernel (the JAX package has no attention); it runs the 36
attentions of the SwinIR generator (``models/architecture.py``). Input is
the qkv linear's token-major output ``(B, Hp, Wp, 3 C)`` (channel ``which *
C + head * hd + d``), output ``(B, Hp, Wp, C)`` (channel ``head * hd + d``)
for the proj linear, both at the tokens' own (unrolled) places:

    o[t] = sum_j softmax_j(scale q_t . k_j + bias[head, i, j] + mask(i, j)) v_j

over the tokens j of t's window in the map rolled by ``-shift``; i and j are
window-local indices; ``mask`` is -100 between the shifted map's regions.
The kernel does the roll, the partition and the mask by index arithmetic
(``tests/test_torch_swinir.py`` mirrors it); the plain version rolls and
partitions.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(bf16, window 8, head dim up to 32) or raises. :data:`LAUNCHES` counts the
launches.
"""

from __future__ import annotations

import torch

from esr_tpu_torch.ops.cuda import lib

__all__ = [
    "LAUNCHES",
    "relative_bias",
    "shift_mask",
    "window_attention",
    "window_attention_launch",
    "window_attention_reference",
]

LAUNCHES = lib.LaunchCounter("window_attn")
KERNEL_WINDOW = 8  # the kernel's window edge
KERNEL_MAX_HD = 32  # head dim, padded to 32 inside
KERNEL_MAX_HEADS = 8


def relative_bias(table: torch.Tensor, ws: int) -> torch.Tensor:
    """The dense (heads, ws^2, ws^2) f32 bias of a relative position bias
    table ((2 ws - 1)^2, heads), indexed as SwinIR's
    ``relative_position_index``: entry (i, j) of window-local tokens i = (yi,
    xi), j = (yj, xj) is row (yi - yj + ws - 1) (2 ws - 1) + xi - xj + ws - 1."""
    r = torch.arange(ws, device=table.device)
    y, x = r.repeat_interleave(ws), r.repeat(ws)
    index = (y[:, None] - y[None, :] + ws - 1) * (2 * ws - 1) + (x[:, None] - x[None, :] + ws - 1)
    return table.float()[index].permute(2, 0, 1).contiguous()


def _regions_1d(n: int, ws: int, shift: int, device) -> torch.Tensor:
    r = torch.arange(n, device=device)
    return (r >= n - ws).long() + (r >= n - shift).long()


def shift_mask(h: int, w: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """(windows, ws^2, ws^2) f32: -100 between the tokens of a window of the
    (h, w) map rolled by ``-shift`` that lie in different regions (rows and
    columns cut at ``-ws`` and ``-shift``), else 0 (SwinIR's ``calculate_mask``)."""
    ids = _regions_1d(h, ws, shift, device)[:, None] * 3 + _regions_1d(w, ws, shift, device)[None, :]
    win = ids.view(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return (win[:, None, :] != win[:, :, None]).float() * -100.0


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor, heads: int, ws: int,
                               shift: int) -> torch.Tensor:
    """The plain version: roll, window partition, softmax(scale q k^T + bias
    + mask) v (scores and softmax in f32, the products in ``qkv``'s dtype),
    windows back, roll back. ``bias``: (heads, ws^2, ws^2)."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    n = ws * ws
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = x.reshape(b, h // ws, ws, w // ws, ws, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = x.reshape(3, -1, heads, n, hd)
    attn = (q @ k.transpose(-2, -1)).float() * hd**-0.5 + bias.float()
    if shift:
        mask = shift_mask(h, w, ws, shift, qkv.device)
        attn = (attn.view(b, mask.shape[0], heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    o = attn.softmax(-1).to(qkv.dtype) @ v
    o = o.view(b, h // ws, w // ws, heads, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, heads: int, ws: int, shift: int) -> torch.Tensor:
    """Window attention of one block (see the module's note): the plain
    version on the CPU, the kernel on CUDA."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, heads, ws, shift)
    return window_attention_launch(qkv, bias, heads, ws, shift)


def window_attention_launch(qkv: torch.Tensor, bias: torch.Tensor, heads: int, ws: int,
                            shift: int) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors: ``qkv`` (B, Hp, Wp, 3 C)
    bf16, ``bias`` (heads, 64, 64) f32 on the same card; window 8, Hp and Wp
    multiples of 8, head dim C / heads even and at most 32, at most 8 heads,
    shift 0 or in (0, 8). Anything else raises."""
    what = "window_attention"
    if not qkv.is_cuda:
        raise RuntimeError(f"{what}: no kernel for device {qkv.device}")
    lib.forward_only(what, qkv, bias)
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads if heads else 0
    ok = (qkv.dtype == torch.bfloat16 and ws == KERNEL_WINDOW and c3 == 3 * c and c == heads * hd
          and 2 <= hd <= KERNEL_MAX_HD and hd % 2 == 0 and heads <= KERNEL_MAX_HEADS and c3 % 4 == 0
          and h % ws == 0 and w % ws == 0 and 0 <= shift < ws)
    if not ok:
        raise ValueError(f"{what}: the kernel takes bf16 qkv (B, Hp, Wp, 3 heads hd), window {KERNEL_WINDOW}, Hp "
                         f"and Wp multiples of it, an even head dim up to {KERNEL_MAX_HD}, at most "
                         f"{KERNEL_MAX_HEADS} heads; got {tuple(qkv.shape)} {qkv.dtype}, {heads} heads, window {ws}")
    if (bias.dtype != torch.float32 or bias.device != qkv.device or tuple(bias.shape) != (heads, ws * ws, ws * ws)):
        raise ValueError(f"{what}: bias (heads, 64, 64) f32 on {qkv.device} expected, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    qkv = lib.aligned16(qkv)
    bias = lib.aligned16(bias)
    out = torch.empty((b, h, w, c), device=qkv.device, dtype=qkv.dtype)
    so = lib.load("window_attn")
    err = so.esr_window_attn(lib.ptr(qkv), lib.ptr(bias), lib.ptr(out), b, h, w, heads, hd, shift,
                             float(hd**-0.5), lib.stream(qkv))
    lib.check(so, err, f"{what} launch")
    LAUNCHES.count += 1
    return out
