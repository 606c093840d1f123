"""SAME 3x3 convolution: the ``conv3x3`` CUDA kernel and its plain PyTorch
version. The same kernel has a 2x2 mode that runs the four parity convs of
the fused nearest-2x upsample (``esr_tpu_torch/ops/fused.py``).

Port of ``esr_tpu/ops/pallas/kpack_conv.py::kpack_conv3x3`` (NHWC x HWIO,
f32 accumulation), with a fused bias + LeakyReLU(0.2) epilogue that the plain
version computes too. A CPU tensor takes the plain version; a CUDA tensor
launches a kernel (``csrc/conv3x3.cuh``) or raises. Three routes, by dtype
and width: bf16 with Cin and Cout up to 64 runs the tensor-core kernel (the
main path); a wider bf16 conv runs the SIMT kernel in bf16; f32 runs the
SIMT kernel in f32. Each route counts its launches under its own name
(:data:`LAUNCHES`, :data:`LAUNCHES_UP`, :data:`LAUNCHES_SIMT`). The kernels
read their weights in their own layout (:func:`conv_kernel_weights`): the
wrappers build it per call, a module can build it once and call
:func:`conv_launch`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import lib

__all__ = [
    "LAUNCHES",
    "LAUNCHES_SIMT",
    "LAUNCHES_UP",
    "LAYOUTS",
    "ConvKernelWeights",
    "conv3x3_reference",
    "conv_kernel_weights",
    "conv_launch",
    "kpack_conv3x3",
    "parity_kernels",
    "sw128_rows",
    "wgmma_weight_image",
]

# launches by route and mode: the tensor-core kernel (bf16, Cin and Cout up
# to 64: the main path) in 3x3 and 2x2 mode, the SIMT kernel by mode and
# dtype; and the weight layouts built
LAUNCHES = lib.LaunchCounter("conv3x3")
LAUNCHES_UP = lib.LaunchCounter("upsample2x_conv3x3")
LAUNCHES_SIMT = {
    (ksize, dt): lib.LaunchCounter(f"{name}_simt_{dt}")
    for ksize, name in ((3, "conv3x3"), (2, "upsample2x_conv3x3")) for dt in ("bf16", "f32")
}
LAYOUTS = lib.LaunchCounter("conv_kernel_weights")

_DTYPES = (torch.bfloat16, torch.float32)
_TC_MAX = 64  # the tensor-core kernel's widest Cin and Cout
_SMEM_LIMIT = 232448
_ROUTE_CODE = {("simt", torch.float32): 0, ("tc", torch.bfloat16): 1, ("simt", torch.bfloat16): 2}


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
    """Per-tap weights [parities, taps, Cin, Cout] (Cin, Cout <= 64) -> the
    tensor-core kernel's shared-memory image [parities * taps, Cout_pad, 64], with
    Cin_pad and Cout_pad: each tap a K-major wgmma operand of Cout_pad (8 or
    64) rows of 64 K values, zero-padded and 128B-swizzled (the B operand
    when Cout <= 8, the A operand of out^T = W^T x^T otherwise), of which the
    kernel reads the first Cin_pad (16 or 64). Keeps ``wt``'s dtype."""
    cin, cout = wt.shape[-2:]
    if cin > 64 or cout > 64:
        raise ValueError(f"conv3x3: the tensor-core kernel takes Cin and Cout up to 64, got {cin}, {cout}")
    cin_pad, cout_pad = (16 if cin <= 16 else 64), (8 if cout <= 8 else 64)
    wt = F.pad(wt, (0, cout_pad - cout, 0, 64 - cin))
    return sw128_rows(wt.transpose(-1, -2).reshape(-1, cout_pad, 64)).contiguous(), cin_pad, cout_pad


class ConvKernelWeights(NamedTuple):
    """One conv's weights in the kernel's layout, for one dtype and device."""

    # tc: the wgmma operand image [parities * taps][cout_pad][64] (K-major
    # rows, 128B-swizzled); simt: [parities][taps][Cin][Cout_pad]
    wt: torch.Tensor
    bias: torch.Tensor | None  # f32, zero-padded to cout_pad
    ksize: int  # 3: SAME 3x3; 2: the four parity 2x2 convs of a nearest-2x upsample
    cin: int
    cin_pad: int  # tc: the K the kernel reads per tap (16 or 64)
    cout: int
    cout_pad: int  # tc: 8 (Cout <= 8) or 64; simt: Cout rounded up to 8
    route: str  # "tc" (tensor cores) or "simt"


@torch.no_grad()
def conv_kernel_weights(
    kernel: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype, device: torch.device,
    ksize: int = 3,
) -> ConvKernelWeights:
    """HWIO 3x3 ``kernel`` (and ``bias``) -> the kernel's layout in ``dtype``.

    ``ksize=2`` takes the parity kernels of the nearest-2x rewrite. bf16 with
    Cin and Cout at most 64 (tensor cores): :func:`wgmma_weight_image`, which
    the kernel copies into shared memory as it is. Wider bf16 convs and f32
    (SIMT): Cout is zero-padded to a multiple of 8."""
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
    route = "tc" if dtype == torch.bfloat16 and cin <= _TC_MAX and cout <= _TC_MAX else "simt"
    if route == "tc":
        wt, cin_pad, cout_pad = wgmma_weight_image(wt)
    else:
        cin_pad, cout_pad = cin, -(-cout // 8) * 8
        wt = F.pad(wt, (0, cout_pad - cout)).contiguous()
    if bias is not None:
        bias = F.pad(bias.to(device=device, dtype=torch.float32), (0, cout_pad - cout)).contiguous()
    LAYOUTS.count += 1
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
    so = lib.load("conv3x3")
    n, h, w, cin = x.shape
    up = 2 if kw.ksize == 2 else 1
    route = _ROUTE_CODE[(kw.route, x.dtype)]
    tc = kw.route == "tc"
    # the tensor-core kernel writes Cout 8 < Cout < 64 as 64 channels (its TMA
    # stores take whole 128-byte pixels); the padding is sliced off below
    cout = kw.cout_pad if tc and kw.cout_pad == 64 else kw.cout
    out = torch.empty((n, up * h, up * w, cout), device=x.device, dtype=x.dtype)
    x = lib.aligned16(x)
    smem = so.esr_conv_smem_bytes(route, cin, kw.cout_pad, kw.ksize)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: Cin={cin} needs {smem} B of shared memory, "
                         f"more than the {_SMEM_LIMIT} B a block can use")
    err = so.esr_conv(
        route, lib.ptr(x), lib.ptr(kw.wt), lib.ptr(kw.bias), lib.ptr(out),
        n, h, w, cin, kw.cin_pad, cout, kw.cout_pad, kw.ksize, int(act), lib.stream(x),
    )
    lib.check(so, err, f"{what} launch")
    if tc:
        (LAUNCHES if kw.ksize == 3 else LAUNCHES_UP).count += 1
    else:
        LAUNCHES_SIMT[(kw.ksize, "bf16" if x.dtype == torch.bfloat16 else "f32")].count += 1
    return out if cout == kw.cout else out[..., : kw.cout].contiguous()


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (bfloat16, float32)")
