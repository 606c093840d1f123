"""SAME 3x3 convolution: the ``conv3x3`` CUDA kernel and its plain PyTorch
version. The same kernel has a 2x2 mode that runs the four parity convs of
the fused nearest-2x upsample (``esr_tpu_torch/ops/fused.py``).

Port of ``esr_tpu/ops/pallas/kpack_conv.py::kpack_conv3x3`` (NHWC x HWIO,
f32 accumulation), with a fused bias + LeakyReLU(0.2) epilogue that the plain
version computes too. A CPU tensor takes the plain version; a CUDA tensor
launches a kernel or raises. Two routes, by dtype: bf16 runs the
tensor-core kernel (``csrc/conv3x3.cuh``; Cin up to 128, Cout up to 1024, a
wider conv raises ``ValueError``); f32 runs the f32 kernel
(``csrc/conv_f32.cuh``: full f32 FMAs on the FP32 units, any Cin and Cout),
for evaluation that must be exact to float error. Each route counts its
launches under its own name (:data:`LAUNCHES`, :data:`LAUNCHES_UP`,
:data:`LAUNCHES_SIMT`), and :data:`LAUNCHES_F32` counts every launch of the
f32 kernel, those of the f32 RDB too. The kernels read their weights in
their own layout (:func:`conv_kernel_weights`): the wrappers build it per
call, a module can build it once and call :func:`conv_launch`. The f32 kernel also reads two
concatenated inputs and writes at a channel offset with a residual
(:func:`conv_f32_launch`): the f32 RDB is five of its launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import lib

__all__ = [
    "LAUNCHES",
    "LAUNCHES_F32",
    "LAUNCHES_SIMT",
    "LAUNCHES_UP",
    "LAYOUTS",
    "ConvKernelWeights",
    "conv3x3_reference",
    "conv_f32_launch",
    "conv_kernel_weights",
    "conv_launch",
    "f32_weight_layout",
    "f32_width",
    "kpack_conv3x3",
    "parity_kernels",
    "sw128_rows",
    "wgmma_weight_image",
]

# launches by route and mode: the tensor-core kernel (bf16) in 3x3 and 2x2
# mode, the f32 route (FP32 units, "SIMT") by mode; every launch of the f32
# kernel, whoever calls it (a conv on the f32 route is one, an f32 RDB five);
# and the weight layouts built
LAUNCHES = lib.LaunchCounter("conv3x3")
LAUNCHES_UP = lib.LaunchCounter("upsample2x_conv3x3")
LAUNCHES_SIMT = {
    (ksize, "f32"): lib.LaunchCounter(f"{name}_simt_f32")
    for ksize, name in ((3, "conv3x3"), (2, "upsample2x_conv3x3"))
}
LAUNCHES_F32 = lib.LaunchCounter("conv_f32_kernel")
LAYOUTS = lib.LaunchCounter("conv_kernel_weights")

_DTYPES = (torch.bfloat16, torch.float32)
# the tensor-core kernel's widest Cin (two K chunks of 64: a third chunk's 3x3
# weights alone would fill the block's shared memory) and Cout (16 slices of 64)
_TC_MAX_CIN, _TC_MAX_COUT = 128, 1024
# the f32 kernel: input channels per K chunk, and the Cout slice widths of its
# instances (a Cout of at most 8, 16 or 32 takes that width; wider ones
# slices of 64)
_F32_KC = 8
_F32_WIDTHS = (8, 16, 32, 64)


def _epilogue(y: torch.Tensor, act: bool) -> torch.Tensor:
    return F.leaky_relu(y, 0.2) if act else y


def conv3x3_reference(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, act: bool = False
) -> torch.Tensor:
    """``F.conv2d`` SAME 3x3: x (B, H, W, Cin), kernel HWIO (3, 3, Cin, Cout),
    computed in ``x.dtype``; optional bias, then optional lrelu_0.2."""
    dt = x.dtype
    b = None if bias is None else bias.to(dt)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(dt), b, padding=1)
    return _epilogue(y, act).permute(0, 2, 3, 1)


def _collapse(w: torch.Tensor, parity: int, axis: int) -> torch.Tensor:
    """Collapse the 3 taps along ``axis`` to the 2 that alias for ``parity``."""
    w0, w1, w2 = torch.split(w, 1, dim=axis)
    if parity == 0:
        return torch.cat([w0, w1 + w2], dim=axis)
    return torch.cat([w0 + w1, w2], dim=axis)


def parity_kernels(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO 3x3 kernel -> (4, 2, 2, Cin, Cout): the 2x2 kernel of each output
    parity q = 2a + b of ``conv3x3(nearest_2x(x))`` (esr_tpu/ops/fused.py)."""
    return torch.stack(
        [_collapse(_collapse(kernel, a, 0), b, 1) for a in (0, 1) for b in (0, 1)]
    )


def sw128_rows(m: torch.Tensor) -> torch.Tensor:
    """Rows of 64 two-byte values [..., R, 64] -> the same rows with 16-byte
    chunk c of row r stored at chunk c ^ (r % 8): the 128-byte swizzle that
    TMA writes and wgmma reads (``csrc/hopper.cuh``). It is its own inverse."""
    *lead, r, k = m.shape
    if k != 64:
        raise ValueError(f"sw128_rows: rows of 64 values expected, got {k}")
    t = m.reshape(*lead, r, 8, 8)
    rows = torch.arange(r, device=m.device) % 8
    idx = (torch.arange(8, device=m.device)[None, :] ^ rows[:, None])[..., None].expand(r, 8, 8)
    return torch.gather(t, -2, idx.expand(*lead, r, 8, 8)).reshape(m.shape)


def wgmma_weight_image(wt: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """Per-tap weights [parities, taps, Cin, Cout] (Cin <= 128, Cout <= 1024)
    -> the tensor-core kernel's shared-memory image, with Cin_pad and
    Cout_pad. The image is [parity row][slice][K chunk][parity][tap][N][64],
    one K-major wgmma operand per (slice, K chunk, parity, tap): N = 8 rows
    (Cout <= 8, one slice: the B operand) or 64 (a slice of 64 output
    channels: the A operand of out^T = W^T x^T), each of 64 K values, zero-
    padded and 128B-swizzled. A block's weights (one parity row of the 2x2
    mode and one slice) are contiguous. Cin_pad is the K the kernel reads:
    16 (Cin <= 16) or 64 per K chunk; Cout_pad is 8 or a multiple of 64.
    Keeps ``wt``'s dtype."""
    par, taps, cin, cout = wt.shape
    if cin > _TC_MAX_CIN or cout > _TC_MAX_COUT:
        raise ValueError(f"conv3x3: the tensor-core kernel takes Cin up to {_TC_MAX_CIN} and Cout up to "
                         f"{_TC_MAX_COUT}, got {cin}, {cout}")
    kc = -(-cin // 64)
    n, slices = (8, 1) if cout <= 8 else (64, -(-cout // 64))
    cin_pad, cout_pad = (16 if cin <= 16 else 64 * kc), n * slices
    rows = 2 if par == 4 else 1  # the 2x2 mode's parity rows a; a block's parities b
    wt = F.pad(wt, (0, cout_pad - cout, 0, 64 * kc - cin))
    wt = wt.reshape(rows, par // rows, taps, kc, 64, slices, n).permute(0, 5, 3, 1, 2, 6, 4)
    return sw128_rows(wt.reshape(-1, n, 64)).contiguous(), cin_pad, cout_pad


def f32_width(cout: int) -> int:
    """The f32 kernel instance's Cout slice width N for ``cout``."""
    return next(n for n in _F32_WIDTHS if cout <= n or n == _F32_WIDTHS[-1])


def f32_weight_layout(wt: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """Per-tap weights [parities, taps, Cin, Cout] -> the f32 kernel's layout
    [slice][chunk][parity][tap][_F32_KC][N] (N = :func:`f32_width`), with
    Cin_pad (whole chunks of 8) and Cout_pad (whole slices), zero-padded. A
    block copies the (slice, chunk) piece it is on into shared memory as it
    is; a thread reads its channels there as 16-byte vectors."""
    par, taps, cin, cout = wt.shape
    n = f32_width(cout)
    slices, chunks = -(-cout // n), -(-cin // _F32_KC)
    wt = F.pad(wt, (0, slices * n - cout, 0, chunks * _F32_KC - cin))
    wt = wt.reshape(par, taps, chunks, _F32_KC, slices, n).permute(4, 2, 0, 1, 3, 5)
    return wt.contiguous(), chunks * _F32_KC, slices * n


class ConvKernelWeights(NamedTuple):
    """One conv's weights in the kernel's layout, for one dtype and device."""

    # tc: the wgmma operand image [parity row][slice][K chunk][parity][tap][N][64]
    # (K-major rows, 128B-swizzled); f32: [slice][chunk][parity][tap][8][N]
    wt: torch.Tensor
    bias: torch.Tensor | None  # f32, zero-padded to cout_pad
    ksize: int  # 3: SAME 3x3; 2: the four parity 2x2 convs of a nearest-2x upsample
    cin: int
    cin_pad: int  # tc: the K the kernel reads per tap (16, or 64 per K chunk); f32: whole chunks of 8
    cout: int
    cout_pad: int  # tc: 8 (Cout <= 8) or a multiple of 64 (slices); f32: whole slices of N
    route: str  # "tc" (tensor cores, bf16) or "f32" (FP32 units)


@torch.no_grad()
def conv_kernel_weights(
    kernel: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype, device: torch.device,
    ksize: int = 3, *, _count: bool = True,
) -> ConvKernelWeights:
    """HWIO 3x3 ``kernel`` (and ``bias``) -> the kernel's layout in ``dtype``.

    ``ksize=2`` takes the parity kernels of the nearest-2x rewrite. bf16
    (tensor cores): :func:`wgmma_weight_image`, which the kernel copies into
    shared memory as it is; a conv wider than it takes raises ``ValueError``.
    f32: :func:`f32_weight_layout`, any width. Counts one build on
    :data:`LAYOUTS` (``_count=False``: the f32 RDB's five convs, which count
    one RDB layout there)."""
    if dtype not in _DTYPES:
        raise TypeError(f"conv3x3: dtype {dtype} not supported (bfloat16, float32)")
    if kernel.dim() != 4 or tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3: kernel (3, 3, Cin, Cout) expected, got {tuple(kernel.shape)}")
    if ksize not in (2, 3):
        raise ValueError(f"conv3x3: ksize {ksize} is neither 3 (SAME) nor 2 (upsample parities)")
    cin, cout = kernel.shape[2], kernel.shape[3]
    if ksize == 3:
        wt = kernel.reshape(1, 9, cin, cout)
    else:
        wt = parity_kernels(kernel).reshape(4, 4, cin, cout)
    wt = wt.to(device=device, dtype=dtype)
    route = "tc" if dtype == torch.bfloat16 else "f32"
    wt, cin_pad, cout_pad = (wgmma_weight_image if route == "tc" else f32_weight_layout)(wt)
    if bias is not None:
        bias = F.pad(bias.to(device=device, dtype=torch.float32), (0, cout_pad - cout)).contiguous()
    LAYOUTS.count += int(_count)
    return ConvKernelWeights(wt, bias, ksize, cin, cin_pad, cout, cout_pad, route)


def kpack_conv3x3(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, act: bool = False
) -> torch.Tensor:
    """SAME 3x3 conv, NHWC x HWIO -> NHWC, f32 accumulation, optional bias and
    lrelu_0.2 epilogue."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, kernel, bias, act)
    _require_cuda(x, "kpack_conv3x3")
    lib.forward_only("kpack_conv3x3", x, kernel, bias)
    return conv_launch(x, conv_kernel_weights(kernel, bias, x.dtype, x.device), act)


def conv_launch(x: torch.Tensor, kw: ConvKernelWeights, act: bool) -> torch.Tensor:
    """Launch the kernel on CUDA tensor ``x`` (N, H, W, Cin) with weights in
    its layout: (N, H, W, Cout) for ``kw.ksize`` 3, (N, 2H, 2W, Cout) for 2."""
    what = "kpack_conv3x3" if kw.ksize == 3 else "upsample2x_conv3x3"
    _require_cuda(x, what)
    lib.forward_only(what, x)
    if x.dim() != 4 or x.shape[3] != kw.cin:
        raise ValueError(f"{what}: x (N, H, W, {kw.cin}) expected, got {tuple(x.shape)}")
    if kw.wt.dtype != x.dtype or kw.wt.device != x.device:
        raise ValueError(f"{what}: weights in {kw.wt.dtype} on {kw.wt.device}, "
                         f"x in {x.dtype} on {x.device}")
    if kw.route == "f32":
        out = conv_f32_launch(x.contiguous(), kw, act)
        LAUNCHES_SIMT[(kw.ksize, "f32")].count += 1
        return out
    so = lib.load("conv3x3")
    n, h, w, cin = x.shape
    up = 2 if kw.ksize == 2 else 1
    # the tensor-core kernel writes a Cout above 8 as whole slices of 64
    # channels (its TMA stores take 128-byte pixel rows); the padding is
    # sliced off below
    cout = kw.cout_pad if kw.cout_pad > 8 else kw.cout
    out = torch.empty((n, up * h, up * w, cout), device=x.device, dtype=x.dtype)
    x = lib.aligned16(x)
    err = so.esr_conv(
        lib.ptr(x), lib.ptr(kw.wt), lib.ptr(kw.bias), lib.ptr(out),
        n, h, w, cin, kw.cin_pad, cout, kw.cout_pad, kw.ksize, int(act), lib.stream(x),
    )
    lib.check(so, err, f"{what} launch")
    (LAUNCHES if kw.ksize == 3 else LAUNCHES_UP).count += 1
    return out if cout == kw.cout else out[..., : kw.cout].contiguous()


def conv_f32_launch(
    x: torch.Tensor, kw: ConvKernelWeights, act: bool, *, x2: torch.Tensor | None = None, cin2: int = 0,
    out: torch.Tensor | None = None, out_c0: int = 0, residual: torch.Tensor | None = None,
    res_scale: float = 1.0,
) -> torch.Tensor:
    """One launch of the f32 kernel (``csrc/conv_f32.cuh``), counted on
    :data:`LAUNCHES_F32` (its callers count their route). The conv's input
    is ``x``'s first ``kw.cin - cin2`` channels followed by ``x2``'s first
    ``cin2`` (the dense concat of an RDB, never built); the result (bias, lrelu if ``act``, then ``residual +
    res_scale *`` it if ``residual`` is given, 3x3 mode only) goes to channels
    ``out_c0 ..`` of ``out`` (a new (N, H, W, Cout) tensor if None; (N, 2H,
    2W, Cout) in 2x2 mode), which is returned. All NHWC f32 on one CUDA
    device, contiguous."""
    what = "conv_f32"
    n, h, w, c1 = x.shape
    cin1 = kw.cin - cin2
    up = 2 if kw.ksize == 2 else 1
    if out is None:
        out = torch.empty((n, up * h, up * w, kw.cout), device=x.device, dtype=x.dtype)
    spatial = (n, up * h, up * w)
    for name, t, width in (("x", x, cin1), ("x2", x2, cin2), ("out", out, out_c0 + kw.cout),
                           ("residual", residual, kw.cout)):
        if t is None:
            if name == "x2" and cin2:
                raise ValueError(f"{what}: cin2={cin2} needs x2")
            continue
        want = (n, h, w) if name in ("x", "x2") else spatial
        if (t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous() or t.dim() != 4
                or tuple(t.shape[:3]) != want or t.shape[3] < width or width < 0):
            raise ValueError(f"{what}: {name} must be a contiguous f32 {want} x >= {width} channels on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if residual is not None and kw.ksize != 3:
        raise ValueError(f"{what}: a residual needs the 3x3 mode")
    if kw.route != "f32" or kw.wt.dtype != torch.float32 or cin1 > c1:
        raise ValueError(f"{what}: f32 weights for Cin {kw.cin} = {cin1} + {cin2} expected")
    so = lib.load("conv3x3")
    err = so.esr_conv_f32(
        lib.ptr(x), c1, cin1, lib.ptr(x2), 0 if x2 is None else x2.shape[3], cin2,
        lib.ptr(kw.wt), lib.ptr(kw.bias), lib.ptr(out), out.shape[3], out_c0,
        lib.ptr(residual), 0 if residual is None else residual.shape[3], float(res_scale),
        n, h, w, kw.cout, f32_width(kw.cout), kw.ksize, int(act), lib.stream(x),
    )
    lib.check(so, err, f"{what} launch")
    LAUNCHES_F32.count += 1
    return out


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (bfloat16, float32)")
