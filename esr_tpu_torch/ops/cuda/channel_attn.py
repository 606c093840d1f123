"""The channel attention of HAT's CAB and the HAB residual it feeds: the
``channel_attn`` CUDA kernels and their plain PyTorch version.

Replaces no TPU kernel (the JAX package has no HAT); it runs the 36 CABs'
channel attentions of a HAT forward (``models/blocks.py::CAB``):

    s = sigmoid(W2 relu(W1 mean_hw(cx) + b1) + b2)      (per image, C -> hidden -> C)
    r = u + scale * s * cx                              (scale: conv_scale, 0.01)

``cx`` (N, H, W, ldc) is the CAB's second conv, of which the first C
channels are read (the conv kernel writes whole Cout slices of 64); ``u``
and ``r`` are (N, H, W, C). ``r`` is the residual the attention's proj
linear adds in its epilogue. A CPU tensor takes the plain version, in f32
then rounded to ``u``'s dtype; a CUDA tensor runs the kernels (bf16 maps,
C a multiple of 4, ldc a multiple of 8 up to 256): a pool whose last block
per image squeezes, then a scale pass (``csrc/channel_attn.cu``).
:data:`LAUNCHES` counts the calls (two kernel launches each).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import lib

__all__ = ["LAUNCHES", "channel_attention", "channel_attention_launch", "channel_attention_reference"]

LAUNCHES = lib.LaunchCounter("channel_attn")
KERNEL_MAX_LDC = 256
KERNEL_MAX_HIDDEN = 32


def channel_attention_reference(cx: torch.Tensor, u: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                                w2: torch.Tensor, b2: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain version: the per-image mean, the squeeze and the scale in f32."""
    c = u.shape[-1]
    x = cx[..., :c].float()
    s = torch.sigmoid(F.linear(F.relu(F.linear(x.mean((1, 2)), w1.float(), b1.float())), w2.float(), b2.float()))
    return (u.float() + scale * x * s[:, None, None, :]).to(u.dtype)


def channel_attention(cx: torch.Tensor, u: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, scale: float) -> torch.Tensor:
    """The channel attention and the residual (see the module's note): the
    plain version on the CPU, the kernels on CUDA."""
    if cx.device.type == "cpu":
        return channel_attention_reference(cx, u, w1, b1, w2, b2, scale)
    return channel_attention_launch(cx, u, w1, b1, w2, b2, scale)


def channel_attention_launch(cx: torch.Tensor, u: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor, scale: float) -> torch.Tensor:
    """One call of the kernels on CUDA tensors: ``cx`` (N, H, W, ldc) and
    ``u`` (N, H, W, C) bf16, ``w1`` (hidden, C), ``b1`` (hidden,), ``w2``
    (C, hidden), ``b2`` (C,) f32 on the same card; C a multiple of 4, ldc a
    multiple of 8 in [C, 256], hidden up to 32. Anything else raises."""
    what = "channel_attention"
    if not cx.is_cuda:
        raise RuntimeError(f"{what}: no kernel for device {cx.device}")
    lib.forward_only(what, cx, u, w1, b1, w2, b2)
    n, h, w, ldc = cx.shape
    c = u.shape[-1]
    hidden = w1.shape[0]
    ok = (cx.dtype == u.dtype == torch.bfloat16 and tuple(u.shape) == (n, h, w, c) and c % 4 == 0
          and ldc % 8 == 0 and c <= ldc <= KERNEL_MAX_LDC and 1 <= hidden <= KERNEL_MAX_HIDDEN)
    if not ok:
        raise ValueError(f"{what}: bf16 cx (N, H, W, ldc) and u (N, H, W, C), C a multiple of 4, ldc a multiple "
                         f"of 8 in [C, {KERNEL_MAX_LDC}], hidden up to {KERNEL_MAX_HIDDEN} expected; got "
                         f"{tuple(cx.shape)} {cx.dtype}, {tuple(u.shape)} {u.dtype}, hidden {hidden}")
    for name, t, shape in (("w1", w1, (hidden, c)), ("b1", b1, (hidden,)), ("w2", w2, (c, hidden)), ("b2", b2, (c,))):
        if t.dtype != torch.float32 or t.device != cx.device or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} {shape} f32 on {cx.device} expected, got {tuple(t.shape)} {t.dtype}")
    sms = torch.cuda.get_device_properties(cx.device).multi_processor_count
    hw = h * w
    parts = max(1, min(hw, -(-4 * sms // max(n, 1))))  # ~4 pool blocks an SM
    blocks_x = max(1, min(-(-hw // (256 // (c // 4))), -(-8 * sms // max(n, 1))))  # ~8 scale blocks an SM
    cx, u = lib.aligned16(cx), lib.aligned16(u)
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    part = torch.empty(n * parts * ldc, device=cx.device, dtype=torch.float32)
    s = torch.empty(n * c, device=cx.device, dtype=torch.float32)
    done = torch.zeros(n, device=cx.device, dtype=torch.int32)
    out = torch.empty_like(u)
    so = lib.load("channel_attn")
    err = so.esr_channel_attn(lib.ptr(cx), lib.ptr(u), lib.ptr(w1), lib.ptr(b1), lib.ptr(w2), lib.ptr(b2),
                              lib.ptr(part), lib.ptr(s), lib.ptr(done), lib.ptr(out), n, hw, c, ldc, hidden, parts,
                              blocks_x, float(scale), lib.stream(cx))
    lib.check(so, err, f"{what} launch")
    LAUNCHES.count += 1
    return out
