"""Gradients for the CUDA kernels: one ``torch.autograd.Function`` per kernel.

The Pallas kernels of the JAX package have no backward, and its training
step never calls them: the JAX generator trains through XLA convs and XLA's
autodiff. The port's training step runs the generator's forward through its
kernels all the same, so each kernel gets a Function:

- **forward** launches the kernel (the wrapper counts the launch) on the
  weight layout it is given, or, given none, on one it builds from the live
  parameters (a training step changes them, so no layout is kept across
  calls); it saves only the input and the parameters. A block whose
  parameters are all frozen (the explorer's generator: ``requires_grad``
  off, layouts from ``prepare_kernels``) passes its prebuilt layout, so a Z
  step builds none;
- **backward** is plain PyTorch: it recomputes the same function with the
  kernel's plain version (``rdb5c_reference``, ``conv3x3_reference``,
  ``upsample2x_conv3x3_reference``) under ``torch.enable_grad()``, in the
  forward's dtype (bf16 on the main path; the f32 parameters are cast inside
  the recompute, so their gradients come back f32), and returns
  ``torch.autograd.grad`` for the input and the parameters.

That is recompute per block: the activations an RDB keeps for its backward
are its one 64-channel input. The backward launches no kernel.
"""

from __future__ import annotations

import torch

from esr_tpu_torch.ops.cuda.kpack_conv import conv3x3_reference, conv_kernel_weights, conv_launch
from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_kernel_weights, rdb5c_launch, rdb5c_reference
from esr_tpu_torch.ops.fused import upsample2x_conv3x3_reference

__all__ = ["Conv3x3Fn", "Rdb5cFn", "Upsample2xConvFn", "conv3x3_fn", "rdb5c_fn", "upsample2x_conv3x3_fn"]

_RDB_KEYS = tuple(f"{p}{k}" for k in range(1, 6) for p in ("w", "b"))


def _rdb5c_kernel(x: torch.Tensor, params: dict) -> torch.Tensor:
    return rdb5c_launch(x, rdb5c_kernel_weights(params, x.dtype, x.device))


def _conv_kernel(x: torch.Tensor, kernel: torch.Tensor, bias, act: bool, ksize: int) -> torch.Tensor:
    return conv_launch(x, conv_kernel_weights(kernel, bias, x.dtype, x.device, ksize), act)


def _recompute_grads(fn, inputs: list, needs: tuple, grad_out: torch.Tensor) -> list:
    """``torch.autograd.grad`` of ``fn(*inputs)`` against ``grad_out`` for the
    inputs in ``needs`` (None for the others and for None inputs)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        wanted = [t for t, n in zip(leaves, needs) if t is not None and n]
        if not wanted:
            return [None] * len(inputs)
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, grad_out))
    return [next(grads) if t is not None and n else None for t, n in zip(leaves, needs)]


class Rdb5cFn(torch.autograd.Function):
    """``fused_rdb5c`` forward through the ``rdb5c`` kernel; backward by the
    recompute of ``rdb5c_reference`` (plain PyTorch, see the module
    docstring). Inputs: x (N, H, W, nf), w1, b1, ..., w5, b5 (HWIO), and
    optionally their prebuilt layout (None: built here)."""

    @staticmethod
    def forward(ctx, x, *wb_kw):
        wb, kw = wb_kw[:10], (wb_kw[10] if len(wb_kw) > 10 else None)
        ctx.save_for_backward(x, *wb)
        return _rdb5c_kernel(x, dict(zip(_RDB_KEYS, wb))) if kw is None else rdb5c_launch(x, kw)

    @staticmethod
    def backward(ctx, grad_out):
        def plain(x, *wb):
            return rdb5c_reference(x, dict(zip(_RDB_KEYS, wb)))

        grads = _recompute_grads(plain, list(ctx.saved_tensors), ctx.needs_input_grad[:11], grad_out)
        return (*grads, None)[: len(ctx.needs_input_grad)]


def _conv_forward(ctx, x, kernel, bias, act: bool, ksize: int, kw) -> torch.Tensor:
    ctx.act = act
    ctx.save_for_backward(x, kernel, bias)
    return _conv_kernel(x, kernel, bias, act, ksize) if kw is None else conv_launch(x, kw, act)


def _conv_backward(ctx, grad_out, plain) -> tuple:
    def fn(x, kernel, bias):
        return plain(x, kernel, bias, ctx.act)

    return (*_recompute_grads(fn, list(ctx.saved_tensors), ctx.needs_input_grad[:3], grad_out), None, None)


class Conv3x3Fn(torch.autograd.Function):
    """``kpack_conv3x3`` (SAME 3x3 + bias + optional lrelu) forward through the
    ``conv3x3`` kernel; backward by the recompute of ``conv3x3_reference``
    (plain PyTorch, see the module docstring)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, act, kw=None):
        return _conv_forward(ctx, x, kernel, bias, act, 3, kw)

    @staticmethod
    def backward(ctx, grad_out):
        return _conv_backward(ctx, grad_out, conv3x3_reference)


class Upsample2xConvFn(torch.autograd.Function):
    """``upsample2x_conv3x3`` forward through the ``conv3x3`` kernel's 2x2
    parity mode; backward by the recompute of
    ``upsample2x_conv3x3_reference`` (plain PyTorch, see the module
    docstring)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, act, kw=None):
        return _conv_forward(ctx, x, kernel, bias, act, 2, kw)

    @staticmethod
    def backward(ctx, grad_out):
        return _conv_backward(ctx, grad_out, upsample2x_conv3x3_reference)


def rdb5c_fn(x: torch.Tensor, params: dict, kw=None) -> torch.Tensor:
    """Differentiable ``fused_rdb5c`` on a CUDA tensor (params HWIO ``w1..b5``;
    ``kw``: their prebuilt kernel layout, for frozen weights)."""
    return Rdb5cFn.apply(x, *(params[k] for k in _RDB_KEYS), kw)


def conv3x3_fn(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None, act: bool,
               kw=None) -> torch.Tensor:
    """Differentiable ``kpack_conv3x3`` on a CUDA tensor (``kw``: the prebuilt
    kernel layout of frozen weights)."""
    return Conv3x3Fn.apply(x, kernel, bias, act, kw)


def upsample2x_conv3x3_fn(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
                          act: bool, kw=None) -> torch.Tensor:
    """Differentiable ``upsample2x_conv3x3`` on a CUDA tensor (``kw``: the
    prebuilt kernel layout of frozen weights)."""
    return Upsample2xConvFn.apply(x, kernel, bias, act, kw)
