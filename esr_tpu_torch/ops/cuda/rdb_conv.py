"""Fused ResidualDenseBlock-5C forward: the ``rdb5c`` CUDA kernels and their
plain PyTorch version.

Port of ``esr_tpu/ops/pallas/rdb_conv.py``: ``fused_rdb5c`` and
``fused_rdb5c_tiled`` keep their signatures and both reach the kernels in
``csrc/rdb5c.cuh`` over ``strip`` x ``wtile`` output tiles: bf16 runs the
tensor-core kernel, which takes nf 64, gc 32 and 16 x 16 tiles only (any
other tile raises); f32 runs the SIMT kernel, any tile. The kernels read
their weights in their own layout (:func:`rdb5c_kernel_weights`; bf16:
:func:`rdb5c_weight_image`): the wrappers build it per call, a module can
build it once and call :func:`rdb5c_launch`.
Tensors are NHWC and weights HWIO, as in the JAX package. A CPU tensor takes
:func:`rdb5c_reference`; a CUDA tensor launches a kernel or raises. The
kernels are forward-only, like the Pallas one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import lib
from esr_tpu_torch.ops.cuda.kpack_conv import sw128_rows

__all__ = [
    "LAUNCHES",
    "Rdb5cKernelWeights",
    "fused_rdb5c",
    "fused_rdb5c_tiled",
    "rdb5c_kernel_weights",
    "rdb5c_launch",
    "rdb5c_params_from_module",
    "rdb5c_reference",
    "rdb5c_weight_image",
]

LAUNCHES = lib.LaunchCounter("rdb5c")

# Default tile edge per dtype: the largest square tile whose window fits a
# block's 227 KB of shared memory at nf=64, gc=32 (bf16 16x16: 196 KB, the
# only tile the bf16 kernel takes; f32 8x8: 168 KB). Larger tiles recompute
# less halo.
_DEFAULT_TILE = {torch.bfloat16: 16, torch.float32: 8}
_BF16_NF, _BF16_GC = 64, 32


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
    allowed); tile edges default to the dtype's largest fitting square. bf16
    takes 16 x 16 tiles only, on every device, and raises on others."""
    _check_tile(x.dtype, strip, wtile)
    if x.device.type == "cpu":
        return rdb5c_reference(x, params)
    _require_cuda(x)
    lib.forward_only("fused_rdb5c", x, *params.values())
    return rdb5c_launch(x, rdb5c_kernel_weights(params, x.dtype, x.device), strip, wtile)


class Rdb5cKernelWeights(NamedTuple):
    """One RDB's weights in the kernel's layout, for one dtype and device."""

    wts: tuple[torch.Tensor, ...]  # bf16: (rdb5c_weight_image,); f32: w_k as [9][cin][cout]
    bs: tuple[torch.Tensor, ...]  # f32
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


@torch.no_grad()
def rdb5c_kernel_weights(params: dict, dtype: torch.dtype, device: torch.device) -> Rdb5cKernelWeights:
    """HWIO ``w1..w5``, ``b1..b5`` -> the kernel's layout in ``dtype`` (the
    port's counterpart of ``rdb5c_params_from_flax``'s kernel layout)."""
    if dtype not in _DEFAULT_TILE:
        raise TypeError(f"fused_rdb5c: dtype {dtype} not supported (bfloat16, float32)")
    nf, gc = params["w5"].shape[-1], params["w1"].shape[-1]
    if dtype == torch.bfloat16 and (nf, gc) != (_BF16_NF, _BF16_GC):
        raise ValueError(f"fused_rdb5c: the bf16 kernel takes nf={_BF16_NF}, gc={_BF16_GC}, got {nf}, {gc}")
    if nf % 8 or gc % 8:
        raise ValueError(f"fused_rdb5c: nf={nf} and gc={gc} must be multiples of 8")
    ws, bs = {}, []
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        wk, bk = params[f"w{k}"], params[f"b{k}"]
        if tuple(wk.shape) != (3, 3, cin, cout) or tuple(bk.shape) != (cout,):
            raise ValueError(f"fused_rdb5c: w{k} {tuple(wk.shape)} / b{k} {tuple(bk.shape)} "
                             f"do not fit nf={nf}, gc={gc}")
        ws[f"w{k}"] = wk.to(device=device, dtype=dtype)
        bs.append(bk.to(device=device, dtype=torch.float32).contiguous())
    if dtype == torch.bfloat16:
        wts = (rdb5c_weight_image(ws).contiguous(),)
    else:
        wts = tuple(ws[f"w{k}"].reshape(9, -1, ws[f"w{k}"].shape[-1]).contiguous() for k in range(1, 6))
    return Rdb5cKernelWeights(wts, tuple(bs), nf, gc)


def rdb5c_launch(
    x: torch.Tensor, kw: Rdb5cKernelWeights, strip: int | None = None, wtile: int | None = None
) -> torch.Tensor:
    """Launch the kernel on CUDA tensor ``x`` (N, H, W, nf) with weights in its layout."""
    _require_cuda(x)
    lib.forward_only("fused_rdb5c", x)
    if x.dim() != 4 or x.shape[3] != kw.nf:
        raise ValueError(f"fused_rdb5c: x must be (N, H, W, {kw.nf}), got {tuple(x.shape)}")
    if kw.wts[0].dtype != x.dtype or kw.wts[0].device != x.device:
        raise ValueError(f"fused_rdb5c: weights in {kw.wts[0].dtype} on {kw.wts[0].device}, "
                         f"x in {x.dtype} on {x.device}")
    strip, wtile = _check_tile(x.dtype, strip, wtile)
    is_bf16 = x.dtype == torch.bfloat16
    so = lib.load("rdb5c")
    if is_bf16 and kw.wts[0].numel() * 2 != so.esr_rdb5c_weight_image_bytes():
        raise ValueError("fused_rdb5c: the weight image does not have the kernel's size")
    x = lib.aligned16(x)
    out = torch.empty_like(x)
    n, h, w, nf = x.shape
    smem = so.esr_rdb5c_smem_bytes(int(is_bf16), nf, kw.gc, strip, wtile)
    if smem > 232448:
        raise ValueError(f"fused_rdb5c: a {strip}x{wtile} tile needs {smem} B of shared "
                         "memory, more than the 232448 B a block can use")
    wts = list(kw.wts) + [None] * (5 - len(kw.wts))
    err = so.esr_rdb5c(
        int(is_bf16), lib.ptr(x), lib.ptr(out),
        *[lib.ptr(t) for t in wts], *[lib.ptr(t) for t in kw.bs],
        n, h, w, nf, kw.gc, strip, wtile, lib.stream(x),
    )
    lib.check(so, err, "rdb5c launch")
    LAUNCHES.count += 1
    return out


def _check_tile(dtype: torch.dtype, strip: int | None, wtile: int | None) -> tuple[int, int]:
    """The tile a call runs (defaults filled in); raises for a bf16 tile other than 16 x 16."""
    strip = strip or _DEFAULT_TILE.get(dtype, 0)
    wtile = wtile or strip
    if dtype == torch.bfloat16 and (strip, wtile) != (_DEFAULT_TILE[dtype],) * 2:
        raise ValueError(f"fused_rdb5c: the bf16 kernel takes 16x16 tiles only, got {strip}x{wtile}")
    return strip, wtile


def _require_cuda(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise RuntimeError(f"fused_rdb5c: no kernel for device {x.device}")
    if x.dtype not in _DEFAULT_TILE:
        raise TypeError(f"fused_rdb5c: dtype {x.dtype} not supported (bfloat16, float32)")
