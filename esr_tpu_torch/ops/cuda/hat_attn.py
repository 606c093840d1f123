"""HAT's two attentions: a HAB's (shifted) window self-attention at window
16 and an OCAB's overlapping cross-attention, the ``hat_attn`` CUDA kernel
and their plain PyTorch versions.

Replaces no TPU kernel (the JAX package has no attention); it runs the 36
HAB and 6 OCAB attentions of the HAT generator (``models/architecture.py``).
Input is the qkv linear's token-major output ``(B, Hp, Wp, 3 C)`` (channel
``which * C + head * hd + d``), output ``(B, Hp, Wp, C)`` (channel ``head *
hd + d``) for the proj linear, both at the tokens' own places:

    o[t] = sum_j softmax_j(scale q_t . k_j + bias[head, i, j] + mask(i, j)) v_j

- :func:`hab_attention`: j runs over the 16 x 16 window of t in the map
  rolled by ``-shift``; bias from a ((2 ws - 1)^2, heads) table indexed as
  Swin's (``window_attn.relative_bias``); ``mask`` -100 between the shifted
  map's regions (``window_attn.shift_mask``), none at shift 0.
- :func:`oca_attention`: the queries of each ws x ws window against the
  keys of the wse x wse window centred on it (wse = ws + ws / 2, stride ws,
  zero padding (wse - ws) / 2 at the map's edge: ``nn.Unfold`` of the k and v
  maps); bias from a ((ws + wse - 1)^2, heads) table at the key's offset
  from the query (:func:`oca_bias`); no mask: a key outside the map is zero,
  so it scores its bias alone.

Both take the table transposed, ``(heads, T^2)`` f32 (:func:`kernel_table`:
the layout the kernel copies into shared memory). A CPU tensor takes the
plain version (windows a few at a time); a CUDA tensor launches the kernel
(bf16, window 16, key window 16 or 24, head dim up to 32) or raises.
:data:`LAUNCHES_HAB` and :data:`LAUNCHES_OCA` count the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import lib
from esr_tpu_torch.ops.cuda.window_attn import relative_bias, shift_mask

__all__ = [
    "LAUNCHES_HAB",
    "LAUNCHES_OCA",
    "hab_attention",
    "hab_attention_reference",
    "kernel_table",
    "oca_attention",
    "oca_attention_reference",
    "oca_bias",
    "oca_index",
    "oca_keys",
]

LAUNCHES_HAB = lib.LaunchCounter("hab_attn")
LAUNCHES_OCA = lib.LaunchCounter("oca_attn")
KERNEL_WINDOW = 16  # the kernel's query window edge
KERNEL_MAX_HD = 32  # head dim, padded to 32 inside
WINDOWS_A_STEP = 512  # windows the plain versions take at a time (their scores are 1 to 4 MB a window)


def kernel_table(table: torch.Tensor) -> torch.Tensor:
    """A bias table (T^2, heads) as the kernel reads it: (heads, T^2) f32, contiguous."""
    return table.float().t().contiguous()


def oca_index(ws: int, wse: int, device=None) -> torch.Tensor:
    """(ws^2, wse^2): the table row of query i = (qy, qx) of a ws x ws window
    against key j = (ky, kx) of its wse x wse key window, (ky - qy + ws - 1)
    (ws + wse - 1) + kx - qx + ws - 1: the key's offset from the query, each
    coordinate shifted into 0 .. ws + wse - 2."""
    q, k = torch.arange(ws, device=device), torch.arange(wse, device=device)
    qy, qx = q.repeat_interleave(ws), q.repeat(ws)
    ky, kx = k.repeat_interleave(wse), k.repeat(wse)
    t = ws + wse - 1
    return (ky[None, :] - qy[:, None] + ws - 1) * t + (kx[None, :] - qx[:, None] + ws - 1)


def oca_bias(table_t: torch.Tensor, ws: int, wse: int) -> torch.Tensor:
    """The dense (heads, ws^2, wse^2) f32 bias of a kernel table (heads, T^2)."""
    return table_t.float()[:, oca_index(ws, wse, table_t.device)]


def _windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, heads, hd) -> (B nW, heads, ws^2, hd), windows row-major."""
    b, h, w, nh, hd = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, nh, hd).permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, nh, ws * ws, hd)


def _unwindows(o: torch.Tensor, b: int, h: int, w: int, ws: int) -> torch.Tensor:
    """(B nW, heads, ws^2, hd) -> (B, H, W, heads hd)."""
    nh, hd = o.shape[1], o.shape[3]
    return o.view(b, h // ws, w // ws, nh, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, nh * hd)


def oca_keys(kv: torch.Tensor, ws: int, wse: int) -> torch.Tensor:
    """(B, H, W, ch) -> (B nW, wse^2, ch): each ws x ws window's wse x wse key
    window (stride ws, zero padding (wse - ws) / 2), as ``nn.Unfold``."""
    b, h, w, ch = kv.shape
    cols = F.unfold(kv.permute(0, 3, 1, 2), wse, stride=ws, padding=(wse - ws) // 2)  # (B, ch wse^2, nW)
    return cols.view(b, ch, wse * wse, -1).permute(0, 3, 2, 1).reshape(-1, wse * wse, ch)


def _attend(q, k, v, bias, mask, scale, dtype) -> torch.Tensor:
    """softmax(scale q k^T + bias (+ mask)) v, windows a few at a time: scores
    and softmax in f32, the products in ``dtype``."""
    out = []
    for i in range(0, q.shape[0], WINDOWS_A_STEP):
        sl = slice(i, i + WINDOWS_A_STEP)
        attn = (q[sl] @ k[sl].transpose(-2, -1)).float() * scale + bias
        if mask is not None:
            attn = attn + mask[sl][:, None]
        out.append(attn.softmax(-1).to(dtype) @ v[sl])
    return torch.cat(out)


def hab_attention_reference(qkv: torch.Tensor, table_t: torch.Tensor, heads: int, ws: int,
                            shift: int) -> torch.Tensor:
    """The plain HAB attention: roll, window partition, softmax(scale q k^T +
    bias + mask) v, windows back, roll back."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    q, k, v = (_windows(x[..., i * c:(i + 1) * c].reshape(b, h, w, heads, hd), ws) for i in range(3))
    mask = shift_mask(h, w, ws, shift, qkv.device).repeat(b, 1, 1) if shift else None
    o = _unwindows(_attend(q, k, v, relative_bias(table_t.t(), ws), mask, hd**-0.5, qkv.dtype), b, h, w, ws)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def oca_attention_reference(qkv: torch.Tensor, table_t: torch.Tensor, heads: int, ws: int,
                            wse: int) -> torch.Tensor:
    """The plain OCAB attention: the windows' queries, each window's key
    window unfolded from the k and v maps (zero outside the map), softmax(
    scale q k^T + bias) v, windows back."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    q = _windows(qkv[..., :c].reshape(b, h, w, heads, hd), ws)
    kv = oca_keys(qkv[..., c:], ws, wse).view(-1, wse * wse, 2, heads, hd).permute(2, 0, 3, 1, 4)
    o = _attend(q, kv[0], kv[1], oca_bias(table_t, ws, wse), None, hd**-0.5, qkv.dtype)
    return _unwindows(o, b, h, w, ws)


def hab_attention(qkv: torch.Tensor, table_t: torch.Tensor, heads: int, ws: int, shift: int) -> torch.Tensor:
    """A HAB's attention (see the module's note): the plain version on the
    CPU, the kernel on CUDA."""
    if qkv.device.type == "cpu":
        return hab_attention_reference(qkv, table_t, heads, ws, shift)
    out = _launch(qkv, table_t, heads, ws, ws, shift)
    LAUNCHES_HAB.count += 1
    return out


def oca_attention(qkv: torch.Tensor, table_t: torch.Tensor, heads: int, ws: int, wse: int) -> torch.Tensor:
    """An OCAB's attention (see the module's note): the plain version on the
    CPU, the kernel on CUDA."""
    if qkv.device.type == "cpu":
        return oca_attention_reference(qkv, table_t, heads, ws, wse)
    out = _launch(qkv, table_t, heads, ws, wse, 0)
    LAUNCHES_OCA.count += 1
    return out


def _launch(qkv: torch.Tensor, table_t: torch.Tensor, heads: int, ws: int, wse: int, shift: int) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors: ``qkv`` (B, Hp, Wp, 3 C)
    bf16, ``table_t`` (heads, (ws + wse - 1)^2) f32 on the same card; window
    16, key window 16 (an even shift below 16) or 24 (shift 0), Hp and Wp
    multiples of 16, head dim C / heads even and at most 32. Anything else
    raises."""
    what = "hat_attention"
    if not qkv.is_cuda:
        raise RuntimeError(f"{what}: no kernel for device {qkv.device}")
    lib.forward_only(what, qkv, table_t)
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads if heads else 0
    t = ws + wse - 1
    ok = (qkv.dtype == torch.bfloat16 and ws == KERNEL_WINDOW and c3 == 3 * c and c == heads * hd
          and 2 <= hd <= KERNEL_MAX_HD and hd % 2 == 0 and h % ws == 0 and w % ws == 0 and shift % 2 == 0
          and ((wse == ws and 0 <= shift < ws) or (wse == 24 and shift == 0)))
    if not ok:
        raise ValueError(f"{what}: the kernel takes bf16 qkv (B, Hp, Wp, 3 heads hd), window {KERNEL_WINDOW}, key "
                         f"window 16 (an even shift below 16) or 24 (shift 0), Hp and Wp multiples of 16, an even "
                         f"head dim up to {KERNEL_MAX_HD}; got {tuple(qkv.shape)} {qkv.dtype}, {heads} heads, "
                         f"window {ws}, key window {wse}, shift {shift}")
    if table_t.dtype != torch.float32 or table_t.device != qkv.device or tuple(table_t.shape) != (heads, t * t):
        raise ValueError(f"{what}: table ({heads}, {t * t}) f32 on {qkv.device} expected, got "
                         f"{tuple(table_t.shape)} {table_t.dtype} on {table_t.device}")
    qkv = lib.aligned16(qkv)
    table_t = lib.aligned16(table_t)
    out = torch.empty((b, h, w, c), device=qkv.device, dtype=qkv.dtype)
    so = lib.load("hat_attn")
    err = so.esr_hat_attn(lib.ptr(qkv), lib.ptr(table_t), lib.ptr(out), b, h, w, heads, hd, shift, wse,
                          float(hd**-0.5), lib.stream(qkv))
    lib.check(so, err, f"{what} launch")
    return out
