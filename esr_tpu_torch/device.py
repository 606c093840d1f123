"""Device selection for the port's entry points, and the full-f32 context
of the convs that the JAX package runs at ``Precision.HIGHEST``."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32", "resolve_device"]


@contextlib.contextmanager
def full_f32(deterministic: bool = False):
    """Full f32 inside: TF32 off in cuDNN convs and in matmuls, whatever the
    caller's global settings, and only cuDNN's deterministic algorithms where
    ``deterministic``; the caller's flags are restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=deterministic or cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = prev


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA on a host
    without one, so that no entry point quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the port's entry points run on "
            "the GPU by default — pass device='cpu' for the plain PyTorch path"
        )
    return dev
