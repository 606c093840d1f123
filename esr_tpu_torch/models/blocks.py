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
from esr_tpu_torch.ops.cuda.layernorm import layer_norm
from esr_tpu_torch.ops.cuda.rdb_conv import (
    fused_rdb5c,
    rdb5c_kernel_weights,
    rdb5c_launch,
    rdb5c_params_from_module,
)
from esr_tpu_torch.ops.cuda.token_linear import SITES as TOKEN_LINEAR_SITES
from esr_tpu_torch.ops.cuda.token_linear import token_linear, token_linear_launch, token_linear_weights
from esr_tpu_torch.ops.cuda.window_attn import relative_bias, window_attention
from esr_tpu_torch.ops.fused import upsample2x_conv3x3

__all__ = [
    "Conv1x1",
    "ConvLRelu",
    "FusedUpsampleConvLRelu",
    "LayerNorm",
    "Linear",
    "RRDB",
    "ResidualBlockNoBN",
    "ResidualDenseBlock5C",
    "SwinBlock",
    "WindowAttention",
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
    """SAME 3x3 conv + bias, then optional LeakyReLU of ``slope``
    (``kpack_conv3x3``; 0.2, or 0.01 where the kernel's epilogue takes it)."""

    ksize = 3  # the conv3x3 kernel's mode
    kernel_weights = None  # the kernel's weight layout, from prepare_kernel

    def __init__(self, in_ch: int, features: int, act: bool = True, init_scale: float = 1.0,
                 generator: torch.Generator | None = None, slope: float = 0.2):
        super().__init__()
        self.act = act
        self.slope = slope
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
                return conv_launch(x, self.kernel_weights, self.act, self.slope)
        elif x.is_cuda:
            if self.act and self.slope != 0.2:
                raise ValueError(f"ConvLRelu: the differentiable conv takes LeakyReLU(0.2) only, not {self.slope}")
            return conv3x3_fn(x, self.hwio(), self.bias, self.act, _frozen_layout(self))
        return kpack_conv3x3(x, self.hwio(), self.bias, self.act, self.slope)


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
    # the row-parallel shard when the trunk is channel-sharded
    # (esr_tpu_torch/parallel/tensor.py): it runs the forward and builds the layouts
    tp = None

    def __init__(self, nf: int = 64, gc: int = 32, generator: torch.Generator | None = None):
        super().__init__()
        for k in range(1, 6):
            conv = ConvLRelu(nf + (k - 1) * gc, nf if k == 5 else gc, act=k < 5,
                             init_scale=0.1, generator=generator)
            self.add_module(f"conv{k}", conv)

    def prepare_kernel(self, dtype: torch.dtype) -> None:
        """Build the weights' kernel layout for ``dtype`` once (none on the CPU)."""
        if self.tp is not None:
            return self.tp.prepare_kernel(self, dtype)
        device = self.conv1.weight.device
        self.kernel_weights = (
            rdb5c_kernel_weights(rdb5c_params_from_module(self), dtype, device)
            if device.type == "cuda" else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.forward(self, x)
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


class _CastWeights(nn.Module):
    """``weight`` and ``bias`` (f32 parameters) used in the input's dtype;
    ``prepare_kernel`` keeps them cast to the compute dtype, so that a
    graphed forward does not cast them at each call."""

    kernel_weights = None  # (weight, bias) in the compute dtype, from prepare_kernel

    def prepare_kernel(self, dtype: torch.dtype) -> None:
        """Cast once (on the card; none on the CPU, as the convs' layouts)."""
        self.kernel_weights = (
            (self.weight.detach().to(dtype), self.bias.detach().to(dtype)) if self.weight.is_cuda else None)

    def _weights(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        kw = self.kernel_weights
        if kw is not None and not torch.is_grad_enabled() and kw[0].dtype == x.dtype:
            return kw
        return self.weight.to(x.dtype), self.bias.to(x.dtype)


class Linear(nn.Module):
    """A token-wise linear layer ``x W^T + b`` (``nn.Linear``'s keys) in the
    input's dtype, with the epilogue its call site asks for: GELU (erf) after
    it, or a residual added. ``token_linear``: the ``token_linear`` kernel on
    the card, given the weight image ``prepare_kernel`` built once (else one
    packed per call); ``F.linear``, ``F.gelu`` and ``+`` on the CPU."""

    kernel_weights = None  # the kernel's weight image, from prepare_kernel

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator | None = None):
        super().__init__()
        std = 0.02  # the released SwinIR's trunc_normal_(std=.02)
        self.weight = nn.Parameter(torch.randn((out_features, in_features), generator=generator) * std)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def prepare_kernel(self, dtype: torch.dtype) -> None:
        """Pack the kernel's weight image once (on the card, in bf16, at a
        width the kernel takes; none otherwise)."""
        w, b = self.weight.detach(), self.bias.detach()
        site = (w.shape[1], w.shape[0]) in TOKEN_LINEAR_SITES
        self.kernel_weights = token_linear_weights(w, b) if w.is_cuda and dtype == torch.bfloat16 and site else None

    def forward(self, x: torch.Tensor, gelu: bool = False, residual: torch.Tensor | None = None) -> torch.Tensor:
        kw = self.kernel_weights
        if kw is not None and x.is_cuda and not torch.is_grad_enabled():
            return token_linear_launch(x, kw, gelu, residual)
        return token_linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype), gelu, residual)


class LayerNorm(_CastWeights):
    """LayerNorm over the channels (eps 1e-5, ``nn.LayerNorm``'s keys) in the
    input's dtype, the statistics in f32 for bf16 input: ``layer_norm`` (the
    ``layernorm`` kernel on the card, ``F.layer_norm`` on the CPU)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, *self._weights(x), self.eps)


class WindowAttention(nn.Module):
    """SwinIR's ``WindowAttention`` of one block, on the roll and the window
    partition the block would make: ``qkv`` and ``proj`` linears and the
    relative position bias table, under the released keys
    (``relative_position_bias_table``, ``qkv``, ``proj``). The attention
    itself is ``window_attention`` (the ``window_attn`` kernel on the card),
    given the dense (heads, ws^2, ws^2) bias: built once by
    ``prepare_kernel``, else from the table at each call."""

    kernel_weights = None  # the dense f32 bias, from prepare_kernel

    def __init__(self, dim: int, heads: int, ws: int, generator: torch.Generator | None = None):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.relative_position_bias_table = nn.Parameter(
            torch.randn(((2 * ws - 1) ** 2, heads), generator=generator) * 0.02)
        self.qkv = Linear(dim, 3 * dim, generator)
        self.proj = Linear(dim, dim, generator)

    def prepare_kernel(self, dtype: torch.dtype) -> None:  # noqa: ARG002 (the bias stays f32)
        """The dense bias, once (on the card; none on the CPU)."""
        table = self.relative_position_bias_table.detach()
        self.kernel_weights = relative_bias(table, self.ws) if table.is_cuda else None

    def forward(self, x: torch.Tensor, shift: int, residual: torch.Tensor | None = None) -> torch.Tensor:
        """``x``: the block's normalised tokens (B, Hp, Wp, C), Hp and Wp
        multiples of the window; the attention's output after ``proj``, at
        the tokens' own places, plus ``residual`` (added in ``proj``'s
        epilogue) when one is given."""
        bias = self.kernel_weights if self.kernel_weights is not None else relative_bias(
            self.relative_position_bias_table, self.ws)
        return self.proj(window_attention(self.qkv(x), bias, self.heads, self.ws, shift), residual=residual)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, generator)
        self.fc2 = Linear(hidden, dim, generator)

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        """fc2(GELU(fc1(x))) (+ ``residual``): GELU in fc1's epilogue, the
        residual in fc2's."""
        return self.fc2(self.fc1(x, gelu=True), residual=residual)


class SwinBlock(nn.Module):
    """A Swin transformer block of SwinIR (``SwinTransformerBlock``, test
    time: no dropout or drop-path), on (B, Hp, Wp, C) tokens:
    ``u + attn(LN1(u))`` at cyclic shift ``shift``, then ``+ mlp(LN2(.))``
    (fc1, GELU with erf, fc2). Keys ``norm1``, ``attn.*``, ``norm2``,
    ``mlp.fc1``, ``mlp.fc2``."""

    def __init__(self, dim: int, heads: int, ws: int, shift: int, mlp_ratio: float,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws, generator)
        self.norm2 = LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), generator)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        u = self.attn(self.norm1(u), self.shift, residual=u)  # u + attn(LN1(u)), the add in proj's epilogue
        return self.mlp(self.norm2(u), residual=u)


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
