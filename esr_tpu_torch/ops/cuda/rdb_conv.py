"""Fused ResidualDenseBlock-5C forward: the ``rdb5c`` CUDA kernel and its
plain PyTorch version.

Port of ``esr_tpu/ops/pallas/rdb_conv.py``: ``fused_rdb5c`` and
``fused_rdb5c_tiled`` keep their signatures and reach the kernels by dtype.
bf16 runs the tensor-core kernel of ``csrc/rdb5c.cuh``, one launch a block,
in one of its instances (:data:`INSTANCES`: nf / gc / tile 32 / 16 / 16, 64
/ 32 / 16, the main path, 64 / 32 / 8 and 128 / 64 / 8). A width runs on the
narrowest instance that holds it, zero-padded to it: zero weights and bias
in the padded channels give x_k = lrelu(0) = 0 there, the later convs read
them through zero weights, and x is padded with zero channels and the output
cut back, so the function is the same. A bf16 RDB wider than nf 128 or gc 64
raises ``ValueError`` on the card. f32 runs the block as five launches of
the f32 conv kernel (``csrc/conv_f32.cuh``, :func:`_rdb5c_f32`), at any
width: conv k reads x and x_1..x_{k-1} from two sources, so the dense concat
is never built, and writes x_k into its channels of one scratch tensor; conv
5 adds the residual. Each dtype counts one launch a block under its own name
(:data:`LAUNCHES`, :data:`LAUNCHES_F32`). At nf 64 / gc 32 each launch
takes the tile of least modelled time for its grid and the card's SMs
(:func:`rdb5c_tile`): 16 x 16, or 8 x 8 where 16 x 16 tiles would leave most
SMs idle (B1-2 x 64^2; :data:`LAUNCHES_SMALL` counts those); both read one
weight image. The ``strip`` x ``wtile`` tile is a schedule hint, as on the
TPU, since tiling changes no output pixel: the kernels choose their own. The
kernels read their weights in their own layout
(:func:`rdb5c_kernel_weights`; bf16: :func:`rdb5c_weight_image` of the
padded weights; f32: :class:`Rdb5cF32Weights`): the wrappers build it per
call, a module can build it once and call :func:`rdb5c_launch`. Tensors are
NHWC and weights HWIO, as in the JAX package. A CPU tensor takes
:func:`rdb5c_reference`, at any width; a CUDA tensor launches a kernel or
raises. The kernels are forward-only, like the Pallas one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import kpack_conv, lib
from esr_tpu_torch.ops.cuda.kpack_conv import ConvKernelWeights, sw128_rows

__all__ = [
    "INSTANCES",
    "LAUNCHES",
    "LAUNCHES_F32",
    "LAUNCHES_SMALL",
    "LAYOUTS",
    "TILE_US",
    "Rdb5cF32Weights",
    "Rdb5cKernelWeights",
    "fused_rdb5c",
    "fused_rdb5c_tiled",
    "rdb5c_instance",
    "rdb5c_kernel_weights",
    "rdb5c_launch",
    "rdb5c_params_from_module",
    "rdb5c_reference",
    "rdb5c_tile",
    "rdb5c_weight_image",
]

# launches, one a block: the bf16 tensor-core kernel (every instance), those
# of them at a smaller tile than their width's largest (rdb5c_tile), and the
# f32 route (five f32 conv launches a block, on the FP32 units); and the
# weight layouts built
LAUNCHES = lib.LaunchCounter("rdb5c")
LAUNCHES_SMALL = lib.LaunchCounter("rdb5c_small")
LAUNCHES_F32 = lib.LaunchCounter("rdb5c_f32")
LAYOUTS = lib.LaunchCounter("rdb5c_kernel_weights")

_DTYPES = (torch.bfloat16, torch.float32)
# the bf16 kernel's instances (nf, gc, tile), narrowest first and, at one
# width, the largest tile first, as csrc/rdb5c.cu lists them
INSTANCES = ((32, 16, 16), (64, 32, 16), (64, 32, 8), (128, 64, 8))
# us a launch of one wave, one tile a block, of the instances that share a
# width (B1 x 64^2: 16 and 64 tiles; ``conv_bench --tiles``, 20 launches in a
# CUDA graph, on an H100 80GB HBM3 at 700 W): the model rdb5c_tile minimises.
# Two waves of 8 x 8 tiles (B1 x 128^2) measured 81-83 us against 67 for one of
# 16 x 16, as the model has it
TILE_US = {(64, 32, 16): 66.3, (64, 32, 8): 41.9}


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
    their own tiles whatever is asked)."""
    if x.device.type == "cpu":
        return rdb5c_reference(x, params)
    _require_cuda(x)
    lib.forward_only("fused_rdb5c", x, *params.values())
    return rdb5c_launch(x, rdb5c_kernel_weights(params, x.dtype, x.device))


class Rdb5cKernelWeights(NamedTuple):
    """One bf16 RDB's weights in the kernel's layout, on one device."""

    image: torch.Tensor  # rdb5c_weight_image of the weights zero-padded to the instance's widths
    bs: tuple[torch.Tensor, ...]  # f32 biases, zero-padded like the weights
    nf: int
    gc: int
    # (nf, gc, tile): the instance widths it is padded to and their largest
    # tile; a launch runs the tile rdb5c_tile picks at those widths
    instance: tuple[int, int, int]


class Rdb5cF32Weights(NamedTuple):
    """One f32 RDB's weights: its five convs in the f32 conv kernel's layout
    (:func:`~esr_tpu_torch.ops.cuda.kpack_conv.f32_weight_layout`, bias
    included), on one device."""

    convs: tuple[ConvKernelWeights, ...]
    nf: int
    gc: int


def rdb5c_instance(nf: int, gc: int) -> tuple[int, int, int]:
    """The narrowest bf16 kernel instance (nf, gc, tile) that holds an RDB
    of these widths, at its largest tile; ``ValueError`` past the widest."""
    for inst in INSTANCES:
        if nf <= inst[0] and gc <= inst[1]:
            return inst
    raise ValueError(f"fused_rdb5c: the bf16 kernel takes nf up to {INSTANCES[-1][0]} and gc up to "
                     f"{INSTANCES[-1][1]}, got nf={nf}, gc={gc} (f32 and the CPU take any width)")


def rdb5c_tile(nf: int, gc: int, n: int, h: int, w: int, sms: int) -> int:
    """The output tile of a bf16 launch at instance widths (nf, gc) on an
    (n, h, w) input with ``sms`` SMs: of the instances at those widths, the
    one of least modelled time, waves x :data:`TILE_US`, where a wave is
    ``sms`` tiles (the launch is persistent, and every instance runs one
    block a SM: its 384 threads hold the SM's registers). Ties go to the
    larger tile, listed first."""
    tiles = [t for f, g, t in INSTANCES if (f, g) == (nf, gc)]
    if len(tiles) == 1:
        return tiles[0]
    return min(tiles, key=lambda t: -(-n * -(-h // t) * -(-w // t) // sms) * TILE_US[(nf, gc, t)])


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rdb5c_weight_image(params: dict) -> torch.Tensor:
    """HWIO ``w1..w5`` at an instance's widths -> the bf16 kernel's weight
    image, flat, in their dtype.

    For each conv k, its K = 9 cin_k values (tap-major, the concat's channel
    order within a tap) are cut into 64-deep k-blocks, the last one
    zero-padded; a k-block is cout_k rows of 64 K values with the 128-byte
    swizzle (:func:`sw128_rows`), the K-major wgmma B operand of its four
    16-deep k-steps. Each conv's k-blocks start at a multiple of their size
    and the image ends at a whole stage (zeros between); the kernel copies
    it to shared memory in stages of ``max(8 KB, 128 nf)`` bytes."""
    parts, size = [], 0  # size in elements of 2 bytes, as the kernel's byte offsets / 2

    def zeros(n):  # a gap in the image (none at nf 64 / gc 32)
        if n:
            parts.append(w.new_zeros(n))
        return n

    for k in range(1, 6):
        w = params[f"w{k}"]
        cin, cout = w.shape[2], w.shape[3]
        size += zeros(-size % (64 * cout))
        m = F.pad(w.reshape(9 * cin, cout), (0, 0, 0, -(-9 * cin // 64) * 64 - 9 * cin))
        parts.append(sw128_rows(m.reshape(-1, 64, cout).transpose(1, 2)).reshape(-1))
        size += parts[-1].numel()
    zeros(-size % (max(8192, 128 * cout) // 2))  # to a whole stage (cout: conv 5's, nf)
    return torch.cat(parts)


def _pad_widths(w: torch.Tensor, b: torch.Tensor, k: int, nf: int, gc: int, nf_p: int,
                gc_p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Conv k's HWIO weight and bias zero-padded to the instance's widths:
    each source feature's cin slice (x: nf, x_j: gc) and the output
    channels."""
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
    five convs' f32 conv layouts for f32 (any width); for bf16 the weight
    image of the narrowest instance that holds nf and gc, the weights and
    biases zero-padded to its widths (``ValueError`` past the widest)."""
    if dtype not in _DTYPES:
        raise TypeError(f"fused_rdb5c: dtype {dtype} not supported (bfloat16, float32)")
    nf, gc = params["w5"].shape[-1], params["w1"].shape[-1]
    inst = rdb5c_instance(nf, gc) if dtype == torch.bfloat16 else None
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
    if inst[:2] != (nf, gc):
        for k in range(1, 6):
            ws[f"w{k}"], bs[k - 1] = _pad_widths(ws[f"w{k}"], bs[k - 1], k, nf, gc, *inst[:2])
    return Rdb5cKernelWeights(rdb5c_weight_image(ws).contiguous(), tuple(b.contiguous() for b in bs), nf, gc, inst)


def rdb5c_launch(x: torch.Tensor, kw: Rdb5cKernelWeights | Rdb5cF32Weights) -> torch.Tensor:
    """Launch the kernel on CUDA tensor ``x`` (N, H, W, nf) with weights in
    its layout."""
    _require_cuda(x)
    lib.forward_only("fused_rdb5c", x)
    if x.dim() != 4 or x.shape[3] != kw.nf:
        raise ValueError(f"fused_rdb5c: x must be (N, H, W, {kw.nf}), got {tuple(x.shape)}")
    f32 = isinstance(kw, Rdb5cF32Weights)
    w = kw.convs[0].wt if f32 else kw.image
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"fused_rdb5c: weights in {w.dtype} on {w.device}, x in {x.dtype} on {x.device}")
    if f32:
        out = _rdb5c_f32(x.contiguous(), kw, kpack_conv.conv_f32_launch)
        LAUNCHES_F32.count += 1
        return out
    nf, gc, _ = kw.instance
    n, h, w, _ = x.shape
    return _launch(x, kw, rdb5c_tile(nf, gc, n, h, w, _sm_count(x.device.index)))


def _launch(x: torch.Tensor, kw: Rdb5cKernelWeights, tile: int) -> torch.Tensor:
    """The bf16 kernel at its instance (kw's widths, ``tile``) on ``x``."""
    so = lib.load("rdb5c")
    nf, gc, _ = kw.instance
    if kw.image.numel() * 2 != so.esr_rdb5c_weight_image_bytes(nf, gc, tile):
        raise ValueError(f"fused_rdb5c: the weight image does not have instance {(nf, gc, tile)}'s size")
    if nf != kw.nf:
        x = F.pad(x, (0, nf - kw.nf))
    x = lib.aligned16(x)
    out = torch.empty_like(x)
    n, h, w, _ = x.shape
    err = so.esr_rdb5c(lib.ptr(x), lib.ptr(out), lib.ptr(kw.image), *[lib.ptr(t) for t in kw.bs],
                       n, h, w, nf, gc, tile, lib.stream(x))
    lib.check(so, err, "rdb5c launch")
    LAUNCHES.count += 1
    LAUNCHES_SMALL.count += tile != kw.instance[2]
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
