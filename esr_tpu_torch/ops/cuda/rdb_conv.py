"""Fused ResidualDenseBlock-5C forward: the ``rdb5c`` CUDA kernels and their
plain PyTorch version.

Port of ``esr_tpu/ops/pallas/rdb_conv.py``: ``fused_rdb5c`` and
``fused_rdb5c_tiled`` keep their signatures and reach the kernels by three
routes, by dtype and width: bf16 at nf 64, gc 32 runs the tensor-core kernel
of ``csrc/rdb5c.cuh`` (the main path); bf16 at any other width runs that
file's SIMT kernel in bf16; f32 runs the block as five launches of the f32
conv kernel (``csrc/conv_f32.cuh``, :func:`_rdb5c_f32`): conv k reads x and
x_1..x_{k-1} from two sources, so the dense concat is never built, and
writes x_k into its channels of one scratch tensor; conv 5 adds the
residual. Each route counts one launch a block under its own name
(:data:`LAUNCHES`, :data:`LAUNCHES_SIMT`), the f32 one too. The ``strip`` x
``wtile`` tile is a schedule hint, as on the TPU, since tiling changes no
output pixel: the bf16 SIMT kernel runs the tile asked for, the tensor-core
kernel its own 16 x 16 and the f32 convs theirs whatever is asked. bf16
widths that are not multiples of 8 are zero-padded in the SIMT weight layout
(zero weights and bias: the padded channels of each x_k are lrelu(0) = 0,
and the later convs read them through zero rows), so the function is the
same. The kernels read their weights in their own layout
(:func:`rdb5c_kernel_weights`; tensor cores: :func:`rdb5c_weight_image`;
f32: :class:`Rdb5cF32Weights`):
the wrappers build it per call, a module can build it once and call
:func:`rdb5c_launch`. Tensors are NHWC and
weights HWIO, as in the JAX package. A CPU tensor takes
:func:`rdb5c_reference`; a CUDA tensor launches a kernel or raises. The
kernels are forward-only, like the Pallas one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import kpack_conv, lib
from esr_tpu_torch.ops.cuda.kpack_conv import ConvKernelWeights, sw128_rows

__all__ = [
    "LAUNCHES",
    "LAUNCHES_SIMT",
    "LAYOUTS",
    "Rdb5cF32Weights",
    "Rdb5cKernelWeights",
    "fused_rdb5c",
    "fused_rdb5c_tiled",
    "rdb5c_kernel_weights",
    "rdb5c_launch",
    "rdb5c_params_from_module",
    "rdb5c_reference",
    "rdb5c_weight_image",
]

# launches by route, one a block: the tensor-core kernel (bf16, nf 64, gc
# 32: the main path), the bf16 SIMT kernel, and the f32 route (five f32 conv
# launches a block); and the weight layouts built
LAUNCHES = lib.LaunchCounter("rdb5c")
LAUNCHES_SIMT = {dt: lib.LaunchCounter(f"rdb5c_simt_{dt}") for dt in ("bf16", "f32")}
LAYOUTS = lib.LaunchCounter("rdb5c_kernel_weights")

_DTYPES = (torch.bfloat16, torch.float32)
# Default tile edge of the bf16 SIMT kernel, halved until the block's window
# fits the 227 KB of shared memory. Larger tiles recompute less halo. The
# tensor-core kernel's tile is 16 x 16.
_SIMT_TILE = 16
_TC_NF, _TC_GC, _TC_TILE = 64, 32, 16
_SMEM_LIMIT = 232448
_ROUTE_CODE = {"tc": 1, "simt": 2}


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def rdb5c_reference(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain dense-concat RDB with ``F.conv2d``s, SAME padding.

    x: (N, H, W, nf); params: ``w1..w5`` HWIO (3, 3, nf + (k-1) gc, gc | nf),
    ``b1..b5``. Computes in ``x.dtype`` (intermediates rounded to it)."""
    dt = x.dtype
    feats = [x.permute(0, 3, 1, 2)]
    for k in range(1, 6):
        w = params[f"w{k}"].permute(3, 2, 0, 1).to(dt)
        y = F.conv2d(torch.cat(feats, 1), w, params[f"b{k}"].to(dt), padding=1)
        if k < 5:
            feats.append(F.leaky_relu(y, 0.2))
    return (feats[0] + 0.2 * y).permute(0, 2, 3, 1)


def rdb5c_params_from_module(rdb) -> dict:
    """Port ``ResidualDenseBlock5C`` module -> this kernel's params dict
    (HWIO weights, as ``rdb5c_params_from_flax`` gives them in JAX)."""
    out = {}
    for k in range(1, 6):
        conv = getattr(rdb, f"conv{k}")
        out[f"w{k}"] = conv.weight.permute(2, 3, 1, 0)
        out[f"b{k}"] = conv.bias
    return out


def fused_rdb5c(x: torch.Tensor, params: dict, strip: int | None = None) -> torch.Tensor:
    """Fused RDB forward with square ``strip`` x ``strip`` output tiles."""
    return fused_rdb5c_tiled(x, params, strip=strip, wtile=strip)


def fused_rdb5c_tiled(
    x: torch.Tensor, params: dict, strip: int | None = None, wtile: int | None = None
) -> torch.Tensor:
    """Fused RDB forward over ``strip`` x ``wtile`` output tiles (ragged edges
    allowed; a schedule hint: the tensor-core kernel and the f32 convs run
    their own tiles whatever is asked). The bf16 SIMT kernel's tile edges
    default to its largest fitting square."""
    if x.device.type == "cpu":
        return rdb5c_reference(x, params)
    _require_cuda(x)
    lib.forward_only("fused_rdb5c", x, *params.values())
    return rdb5c_launch(x, rdb5c_kernel_weights(params, x.dtype, x.device), strip, wtile)


class Rdb5cKernelWeights(NamedTuple):
    """One bf16 RDB's weights in the kernel's layout, on one device."""

    # tc: (rdb5c_weight_image,); simt: w_k as [9][cin_k][cout_k], zero-padded
    # to nf_pad / gc_pad channels per source feature and output
    wts: tuple[torch.Tensor, ...]
    bs: tuple[torch.Tensor, ...]  # f32, zero-padded like the weights
    nf: int
    gc: int
    route: str  # "tc" (tensor cores) or "simt"
    nf_pad: int  # nf and gc as the kernel runs them (simt: rounded up to multiples of 8)
    gc_pad: int


class Rdb5cF32Weights(NamedTuple):
    """One f32 RDB's weights: its five convs in the f32 conv kernel's layout
    (:func:`~esr_tpu_torch.ops.cuda.kpack_conv.f32_weight_layout`, bias
    included), on one device."""

    convs: tuple[ConvKernelWeights, ...]
    nf: int
    gc: int


def rdb5c_weight_image(params: dict) -> torch.Tensor:
    """HWIO ``w1..w5`` -> the bf16 kernel's weight image, flat, in their dtype.

    For each conv k, its K = 9 cin_k values (tap-major, the concat's channel
    order within a tap) are cut into 64-deep k-blocks, the last one
    zero-padded; a k-block is cout_k rows of 64 K values with the 128-byte
    swizzle (:func:`sw128_rows`), the K-major wgmma B operand of its four
    16-deep k-steps. The five convs' k-blocks follow each other; the kernel
    copies the image to shared memory in 8 KB stages."""
    parts = []
    for k in range(1, 6):
        w = params[f"w{k}"]
        cin, cout = w.shape[2], w.shape[3]
        m = w.reshape(9 * cin, cout)
        m = F.pad(m, (0, 0, 0, -(-9 * cin // 64) * 64 - 9 * cin))
        parts.append(sw128_rows(m.reshape(-1, 64, cout).transpose(1, 2)).reshape(-1))
    return torch.cat(parts)


def _pad_simt(w: torch.Tensor, b: torch.Tensor, k: int, nf: int, gc: int, nf_p: int,
              gc_p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Conv k's HWIO weight and bias zero-padded to the padded widths: each
    source feature's cin slice (x: nf, x_j: gc) and the output channels."""
    widths = [nf] + [gc] * (k - 1)
    pads = [nf_p] + [gc_p] * (k - 1)
    parts = torch.split(w, widths, dim=2)
    w = torch.cat([F.pad(t, (0, 0, 0, p - c)) for t, c, p in zip(parts, widths, pads)], dim=2)
    cout_p = nf_p if k == 5 else gc_p
    return F.pad(w, (0, cout_p - w.shape[3])), F.pad(b, (0, cout_p - b.shape[0]))


@torch.no_grad()
def rdb5c_kernel_weights(
    params: dict, dtype: torch.dtype, device: torch.device
) -> Rdb5cKernelWeights | Rdb5cF32Weights:
    """HWIO ``w1..w5``, ``b1..b5`` -> the kernel's layout in ``dtype`` (the
    port's counterpart of ``rdb5c_params_from_flax``'s kernel layout): the
    tensor-core weight image for bf16 at nf 64, gc 32; the five convs' f32
    conv layouts for f32 (any width); else the bf16 SIMT layout, zero-padded
    to multiples of 8 channels."""
    if dtype not in _DTYPES:
        raise TypeError(f"fused_rdb5c: dtype {dtype} not supported (bfloat16, float32)")
    nf, gc = params["w5"].shape[-1], params["w1"].shape[-1]
    ws, bs = {}, []
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        wk, bk = params[f"w{k}"], params[f"b{k}"]
        if tuple(wk.shape) != (3, 3, cin, cout) or tuple(bk.shape) != (cout,):
            raise ValueError(f"fused_rdb5c: w{k} {tuple(wk.shape)} / b{k} {tuple(bk.shape)} "
                             f"do not fit nf={nf}, gc={gc}")
        ws[f"w{k}"] = wk.to(device=device, dtype=dtype)
        bs.append(bk.to(device=device, dtype=torch.float32))
    LAYOUTS.count += 1
    if dtype == torch.float32:
        convs = tuple(kpack_conv.conv_kernel_weights(ws[f"w{k}"], bs[k - 1], dtype, device, _count=False)
                      for k in range(1, 6))
        return Rdb5cF32Weights(convs, nf, gc)
    if dtype == torch.bfloat16 and (nf, gc) == (_TC_NF, _TC_GC):
        return Rdb5cKernelWeights((rdb5c_weight_image(ws).contiguous(),), tuple(b.contiguous() for b in bs),
                                  nf, gc, "tc", nf, gc)
    nf_p, gc_p = _ceil8(nf), _ceil8(gc)
    wts, bps = [], []
    for k in range(1, 6):
        w, b = _pad_simt(ws[f"w{k}"], bs[k - 1], k, nf, gc, nf_p, gc_p)
        wts.append(w.reshape(9, -1, w.shape[-1]).contiguous())
        bps.append(b.contiguous())
    return Rdb5cKernelWeights(tuple(wts), tuple(bps), nf, gc, "simt", nf_p, gc_p)


def rdb5c_launch(
    x: torch.Tensor, kw: Rdb5cKernelWeights | Rdb5cF32Weights, strip: int | None = None, wtile: int | None = None
) -> torch.Tensor:
    """Launch the kernel on CUDA tensor ``x`` (N, H, W, nf) with weights in its layout."""
    _require_cuda(x)
    lib.forward_only("fused_rdb5c", x)
    if x.dim() != 4 or x.shape[3] != kw.nf:
        raise ValueError(f"fused_rdb5c: x must be (N, H, W, {kw.nf}), got {tuple(x.shape)}")
    f32 = isinstance(kw, Rdb5cF32Weights)
    w = kw.convs[0].wt if f32 else kw.wts[0]
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"fused_rdb5c: weights in {w.dtype} on {w.device}, x in {x.dtype} on {x.device}")
    if f32:
        out = _rdb5c_f32(x.contiguous(), kw, kpack_conv.conv_f32_launch)
        LAUNCHES_SIMT["f32"].count += 1
        return out
    so = lib.load("rdb5c")
    route = _ROUTE_CODE[kw.route]
    tc = kw.route == "tc"
    if tc and kw.wts[0].numel() * 2 != so.esr_rdb5c_weight_image_bytes():
        raise ValueError("fused_rdb5c: the weight image does not have the kernel's size")
    nf, gc = kw.nf_pad, kw.gc_pad
    if tc:
        strip = wtile = _TC_TILE
    elif strip is None and wtile is None:  # the default square, halved until it fits
        strip = wtile = _SIMT_TILE
        while strip > 1 and so.esr_rdb5c_smem_bytes(route, nf, gc, strip, strip) > _SMEM_LIMIT:
            strip = wtile = strip // 2
    else:
        strip = strip or wtile
        wtile = wtile or strip
    smem = so.esr_rdb5c_smem_bytes(route, nf, gc, strip, wtile)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_rdb5c: a {strip}x{wtile} tile needs {smem} B of shared "
                         f"memory, more than the {_SMEM_LIMIT} B a block can use")
    if nf != kw.nf:
        x = F.pad(x, (0, nf - kw.nf))
    x = lib.aligned16(x)
    out = torch.empty_like(x)
    n, h, w, _ = x.shape
    wts = list(kw.wts) + [None] * (5 - len(kw.wts))
    err = so.esr_rdb5c(
        route, lib.ptr(x), lib.ptr(out),
        *[lib.ptr(t) for t in wts], *[lib.ptr(t) for t in kw.bs],
        n, h, w, nf, gc, strip, wtile, lib.stream(x),
    )
    lib.check(so, err, "rdb5c launch")
    (LAUNCHES if tc else LAUNCHES_SIMT["bf16"]).count += 1
    return out if nf == kw.nf else out[..., : kw.nf].contiguous()


def _rdb5c_f32(x: torch.Tensor, kw: Rdb5cF32Weights, conv) -> torch.Tensor:
    """The f32 RDB as five launches of ``conv`` (the f32 conv kernel's
    :func:`~esr_tpu_torch.ops.cuda.kpack_conv.conv_f32_launch`): conv k < 5
    reads x and x_1..x_{k-1} (channels [0, (k-1) gc) of one scratch tensor)
    and writes x_k = lrelu(conv + b_k) into channels [(k-1) gc, k gc) of it;
    conv 5 returns x + 0.2 (conv + b_5). Each conv zero-pads at the image
    edge by itself, so no intermediate needs re-zeroing."""
    n, h, w, _ = x.shape
    gc = kw.gc
    scratch = torch.empty((n, h, w, 4 * gc), device=x.device, dtype=x.dtype)
    for k in range(1, 5):
        conv(x, kw.convs[k - 1], True, x2=scratch, cin2=(k - 1) * gc, out=scratch, out_c0=(k - 1) * gc)
    return conv(x, kw.convs[4], False, x2=scratch, cin2=4 * gc, residual=x, res_scale=0.2)


def _require_cuda(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise RuntimeError(f"fused_rdb5c: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_rdb5c: dtype {x.dtype} not supported (bfloat16, float32)")
