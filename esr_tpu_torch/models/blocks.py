"""Building blocks of the RRDB generator (port of esr_tpu/models/blocks.py).

NHWC activations, f32 parameters in the reference torch layout (OIHW, with
the reference ESRGAN names), computation in the input's dtype. The JAX
package's ``fold`` (batch->channel) and ``packed`` (per-source RDB convs) are
TPU MXU-lane layouts whose per-image math is the plain dense-concat RDB, so
the port has no counterpart: its RDB is one ``fused_rdb5c`` call, which
launches the ``rdb5c`` kernel on CUDA and runs ``F.conv2d``s on the CPU.

``prepare_kernel(dtype)`` builds a module's weights in its CUDA kernel's
layout once (``RRDBNet.prepare_kernels``), for forwards under
``torch.no_grad()``; otherwise the wrappers build it per call. With grad on,
a CUDA input goes through the kernel's ``torch.autograd.Function``
(``ops/cuda/autograd.py``: the kernel forward, a plain-PyTorch recompute
backward). It takes the prebuilt layout when the module's parameters are all
frozen (the explorer's Z steps, which differentiate only the input), and
builds the layout from the live weights at every call otherwise (training).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from esr_tpu_torch.ops.cuda.autograd import conv3x3_fn, rdb5c_fn, upsample2x_conv3x3_fn
from esr_tpu_torch.ops.cuda.kpack_conv import conv_kernel_weights, conv_launch, kpack_conv3x3
from esr_tpu_torch.ops.cuda.rdb_conv import (
    fused_rdb5c,
    rdb5c_kernel_weights,
    rdb5c_launch,
    rdb5c_params_from_module,
)
from esr_tpu_torch.ops.fused import upsample2x_conv3x3

__all__ = [
    "Conv1x1",
    "ConvLRelu",
    "FusedUpsampleConvLRelu",
    "RRDB",
    "ResidualBlockNoBN",
    "ResidualDenseBlock5C",
    "kaiming_scaled",
    "lrelu",
    "pixel_shuffle",
    "upsample_nearest",
]


def kaiming_scaled(shape: tuple, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Kaiming-normal (fan_in, gain sqrt(2)) OIHW weight scaled by ``scale``:
    the reference's ``kaiming_normal_`` then ``weight *= 0.1`` for
    residual-branch convs."""
    fan_in = shape[1] * shape[2] * shape[3]
    return torch.randn(shape, generator=generator) * (math.sqrt(2.0 / fan_in) * scale)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _frozen_layout(module: nn.Module):
    """The module's prebuilt kernel layout when none of its parameters needs
    a gradient, else None (the Function then builds it from the live weights)."""
    if module.kernel_weights is None or any(p.requires_grad for p in module.parameters()):
        return None
    return module.kernel_weights


class ConvLRelu(nn.Module):
    """SAME 3x3 conv + bias, then optional lrelu_0.2 (``kpack_conv3x3``)."""

    ksize = 3  # the conv3x3 kernel's mode
    kernel_weights = None  # the kernel's weight layout, from prepare_kernel

    def __init__(self, in_ch: int, features: int, act: bool = True, init_scale: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(kaiming_scaled((features, in_ch, 3, 3), init_scale, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def hwio(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0)

    def prepare_kernel(self, dtype: torch.dtype) -> None:
        """Build the weights' kernel layout for ``dtype`` once (none on the CPU)."""
        self.kernel_weights = (
            conv_kernel_weights(self.hwio(), self.bias, dtype, self.weight.device, self.ksize)
            if self.weight.is_cuda else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled():
            if self.kernel_weights is not None:
                return conv_launch(x, self.kernel_weights, self.act)
        elif x.is_cuda:
            return conv3x3_fn(x, self.hwio(), self.bias, self.act, _frozen_layout(self))
        return kpack_conv3x3(x, self.hwio(), self.bias, self.act)


class FusedUpsampleConvLRelu(ConvLRelu):
    """lrelu(conv3x3(nearest_2x(x))) via the 4-parity 2x2-conv rewrite, with
    the same parameters as upsample + ConvLRelu."""

    ksize = 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled():
            if self.kernel_weights is not None:
                return conv_launch(x, self.kernel_weights, act=True)
        elif x.is_cuda:
            return upsample2x_conv3x3_fn(x, self.hwio(), self.bias, True, _frozen_layout(self))
        return upsample2x_conv3x3(x, self.hwio(), self.bias, act=True)


class Conv1x1(nn.Module):
    """1x1 conv + bias, no activation: a channel matmul in the input's dtype
    (the ``latent_proj`` of ``latent_input='all_layers'``; no kernel)."""

    def __init__(self, in_ch: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(kaiming_scaled((features, in_ch, 1, 1), 1.0, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return F.linear(x, self.weight[:, :, 0, 0].to(dt), self.bias.to(dt))


class ResidualBlockNoBN(nn.Module):
    """SRResNet's residual block: conv, ReLU, conv, + identity (no BN)."""

    def __init__(self, nf: int = 64, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = ConvLRelu(nf, nf, act=False, init_scale=0.1, generator=generator)
        self.conv2 = ConvLRelu(nf, nf, act=False, init_scale=0.1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x)))


class ResidualDenseBlock5C(nn.Module):
    """5-conv dense block: conv_k sees concat(x, x1..x_{k-1}); out = x + 0.2*x5."""

    kernel_weights = None  # the rdb5c kernel's weight layout, from prepare_kernel

    def __init__(self, nf: int = 64, gc: int = 32, generator: torch.Generator | None = None):
        super().__init__()
        for k in range(1, 6):
            conv = ConvLRelu(nf + (k - 1) * gc, nf if k == 5 else gc, act=k < 5,
                             init_scale=0.1, generator=generator)
            self.add_module(f"conv{k}", conv)

    def prepare_kernel(self, dtype: torch.dtype) -> None:
        """Build the weights' kernel layout for ``dtype`` once (none on the CPU)."""
        device = self.conv1.weight.device
        self.kernel_weights = (
            rdb5c_kernel_weights(rdb5c_params_from_module(self), dtype, device)
            if device.type == "cuda" else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled():
            if self.kernel_weights is not None:
                return rdb5c_launch(x, self.kernel_weights)
        elif x.is_cuda:
            return rdb5c_fn(x, rdb5c_params_from_module(self), _frozen_layout(self))
        return fused_rdb5c(x, rdb5c_params_from_module(self))


class RRDB(nn.Module):
    """Residual-in-Residual Dense Block: 3 RDBs, outer x0.2 residual."""

    def __init__(self, nf: int = 64, gc: int = 32, generator: torch.Generator | None = None):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc, generator)
        self.RDB2 = ResidualDenseBlock5C(nf, gc, generator)
        self.RDB3 = ResidualDenseBlock5C(nf, gc, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.2 * self.RDB3(self.RDB2(self.RDB1(x)))


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space, NHWC, with ``torch.pixel_shuffle``'s channel-major
    subpixels: out[h*r + i, w*r + j, c] = x[h, w, c*r*r + i*r + j]."""
    n, h, w, c = x.shape
    r = int(factor)
    x = x.reshape(n, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbor integer upsample, NHWC."""
    n, h, w, c = x.shape
    r = int(factor)
    return x[:, :, None, :, None, :].expand(n, h, r, w, r, c).reshape(n, h * r, w * r, c)
