"""SwinIR's token-wise linear layers with their call site's epilogue: the
``token_linear`` CUDA kernel and its plain PyTorch version.

Replaces no TPU kernel (the JAX package has no SwinIR); it runs the 144
linears of a SwinIR-M forward (``models/blocks.py::Linear``), four a Swin
block, each with the epilogue its call site names:

    attn.qkv   y = x W^T + b                 (K 180, N 540)
    attn.proj  y = u + (x W^T + b)           (K 180, N 180; u the block's input)
    mlp.fc1    y = gelu(x W^T + b)           (K 180, N 360; GELU with erf)
    mlp.fc2    y = u + (x W^T + b)           (K 360, N 180)

A CPU tensor takes the plain version, ``F.linear`` then ``F.gelu`` then
``+`` in ``x``'s dtype (the composition SwinIR's blocks ran before the
kernel), at any width. A CUDA tensor launches the kernel (bf16, one of the
four sites) or raises: bf16 operands, f32 accumulation, the bias, GELU and
the residual added in f32 and one rounding to bf16 at the store (GELU's
Phi from an erfc approximation of fractional error under 1.2e-7, which
unlike ``1 + erf`` does not cancel for large negative inputs). The kernel
reads its weights as an image packed once (:func:`token_linear_weights`,
``Linear.prepare_kernel``): the output columns cut into slabs (180 at K 180,
96 at K 360), each slab's rows of 64 K values 128 bytes long with their
16-byte chunks swizzled by row, K and the slab zero-padded to whole wgmma
steps (``tests/test_torch_linear.py`` decodes it as the kernel's descriptors
read it and emulates the kernel's tile walk). :data:`LAUNCHES` counts the
launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import lib

__all__ = ["LAUNCHES", "SITES", "LinearWeights", "token_linear", "token_linear_launch", "token_linear_reference",
           "token_linear_weights"]

LAUNCHES = lib.LaunchCounter("token_linear")
# (K, N) of SwinIR-M's sites -> the epilogue each takes
SITES = {(180, 540): "bias", (180, 180): "residual", (180, 360): "gelu", (360, 180): "residual"}
# K -> (columns a slab, the slab's padded width: the kernel's wgmma N)
SLABS = {180: (180, 184), 360: (96, 96)}
PANEL = 64  # K values of a 128-byte row of the image
EPILOGUES = ("bias", "gelu", "residual")  # the C interface's codes 0, 1, 2


class LinearWeights(NamedTuple):
    """The kernel's weights for one (K, N): ``image`` [slabs][panels][NW][64]
    bf16 (chunk j of row n holds K values 8 (j ^ (n % 8)) .. + 7 of its
    panel), ``bias`` [slabs][NW] f32."""

    image: torch.Tensor
    bias: torch.Tensor
    k: int
    n: int


def token_linear_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gelu: bool = False,
                           residual: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: ``F.linear``, then ``F.gelu`` (erf), then
    ``residual +``, each in ``x``'s dtype."""
    y = F.linear(x, w, b)
    if gelu:
        y = F.gelu(y)
    return y if residual is None else residual + y


def token_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gelu: bool = False,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """A linear layer and its epilogue (see the module's note): the plain
    version on the CPU, the kernel on CUDA (its weights packed per call)."""
    if x.device.type == "cpu":
        return token_linear_reference(x, w, b, gelu, residual)
    return token_linear_launch(x, token_linear_weights(w, b), gelu, residual)


def _site(k: int, n: int) -> str:
    if (k, n) not in SITES:
        raise ValueError(f"token_linear: the kernel takes SwinIR-M's (K, N) sites "
                         f"{', '.join(f'({a}, {c}) {e}' for (a, c), e in SITES.items())}; got ({k}, {n})")
    return SITES[(k, n)]


def token_linear_weights(w: torch.Tensor, b: torch.Tensor) -> LinearWeights:
    """The kernel's weight image and bias of ``w`` (N, K) and ``b`` (N,),
    both rounded to bf16 (the compute dtype), on their device."""
    n, k = w.shape
    _site(k, n)
    if tuple(b.shape) != (n,):
        raise ValueError(f"token_linear: bias ({n},) expected, got {tuple(b.shape)}")
    ns, nw = SLABS[k]
    slabs = -(-n // ns)
    kp = -(-k // 16) * 16
    panels = -(-kp // PANEL)
    img = torch.zeros(slabs, nw, panels * PANEL, dtype=torch.bfloat16, device=w.device)
    bias = torch.zeros(slabs, nw, dtype=torch.float32, device=w.device)
    for s in range(slabs):
        cols = min(ns, n - s * ns)
        img[s, :cols, :k] = w[s * ns:s * ns + cols].to(torch.bfloat16)
        bias[s, :cols] = b[s * ns:s * ns + cols].to(torch.bfloat16).float()
    img = img.view(slabs, nw, panels, 8, 8).permute(0, 2, 1, 3, 4)  # [slab][panel][row][chunk][8]
    swz = torch.arange(8, device=w.device)[None, :] ^ (torch.arange(nw, device=w.device)[:, None] % 8)
    img = torch.gather(img, 3, swz[None, None, :, :, None].expand(slabs, panels, nw, 8, 8))
    return LinearWeights(img.contiguous(), bias, k, n)


def token_linear_launch(x: torch.Tensor, kw: LinearWeights, gelu: bool = False,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors: ``x`` (..., K) bf16, ``kw``
    from :func:`token_linear_weights` on the same card, (K, N) one of
    :data:`SITES` with the epilogue it names (GELU, or ``residual`` (..., N)
    bf16), and no input that autograd tracks. Anything else raises."""
    what = "token_linear"
    lib.forward_only(what, x, residual)
    k, n = kw.k, kw.n
    epilogue = "gelu" if gelu else "bias" if residual is None else "residual"
    if gelu and residual is not None or _site(k, n) != epilogue:
        raise ValueError(f"{what}: the ({k}, {n}) site takes the {SITES[(k, n)]} epilogue, not {epilogue}"
                         + " and residual" * (gelu and residual is not None))
    if x.dtype != torch.bfloat16 or x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"{what}: bf16 tokens of {k} channels expected, got {tuple(x.shape)} {x.dtype}")
    if residual is not None and (residual.dtype != torch.bfloat16 or residual.device != x.device
                                 or tuple(residual.shape) != tuple(x.shape[:-1]) + (n,)):
        raise ValueError(f"{what}: residual {tuple(x.shape[:-1]) + (n,)} bf16 on {x.device} expected, got "
                         f"{tuple(residual.shape)} {residual.dtype} on {residual.device}")
    if kw.image.device != x.device or kw.bias.device != x.device:
        raise ValueError(f"{what}: weights on {kw.image.device}, tokens on {x.device}")
    if not x.is_cuda:
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    x = lib.aligned16(x)
    r = None if residual is None else lib.aligned16(residual)
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    so = lib.load("token_linear")
    err = so.esr_token_linear(lib.ptr(x), lib.ptr(kw.image), lib.ptr(kw.bias), lib.ptr(r), lib.ptr(out),
                              x.numel() // k, k, n, EPILOGUES.index(epilogue), sms, lib.stream(x))
    lib.check(so, err, f"{what} launch")
    LAUNCHES.count += 1
    return out
