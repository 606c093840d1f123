"""LayerNorm over the last axis (SwinIR's ``patch_embed.norm``, its blocks'
``norm1`` and ``norm2`` and its final ``norm``): the ``layernorm`` CUDA
kernel and its plain PyTorch version.

Replaces no TPU kernel (the JAX package has no LayerNorm); it runs the 74
LayerNorms of a SwinIR-M forward (``models/blocks.py::LayerNorm``):

    y = (x - mean) * rstd * w + b,  rstd = 1 / sqrt(var + eps)

over each row's C channels, the statistics (the variance about the mean)
and the affine step in f32, bf16 in and out, as torch's own kernel does for
bf16. A CPU tensor takes the plain version, ``F.layer_norm``; a CUDA tensor
launches the kernel (bf16 rows, C a multiple of 4 up to 256) or raises.
The kernel moves rows in runs of two (4 C bytes, a whole number of
16-byte chunks), a warp 4 runs a stage of a ring in shared memory, 8 warps
a block, over a grid of at most the blocks the card's SMs hold
(``tests/test_torch_layernorm.py`` mirrors the partition).
:data:`LAUNCHES` counts the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda import lib

__all__ = ["LAUNCHES", "layer_norm", "layer_norm_launch", "layer_norm_reference"]

LAUNCHES = lib.LaunchCounter("layernorm")
KERNEL_MAX_C = 256  # two 16-byte chunks a lane of a run of two rows


def layer_norm_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version: ``F.layer_norm`` over the last axis."""
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (see the module's note): the plain
    version on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, w, b, eps)
    return layer_norm_launch(x, w, b, eps)


def layer_norm_launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors: ``x`` (..., C) bf16, ``w``
    and ``b`` (C,) bf16 on the same card, C a multiple of 4 in [4, 256], and
    no input that autograd tracks. Anything else raises."""
    what = "layer_norm"
    lib.forward_only(what, x, w, b)
    c = x.shape[-1] if x.dim() else 0
    if x.dtype != torch.bfloat16 or c % 4 or not 4 <= c <= KERNEL_MAX_C:
        raise ValueError(f"{what}: the kernel takes bf16 rows of C channels, C a multiple of 4 in [4, "
                         f"{KERNEL_MAX_C}]; got {tuple(x.shape)} {x.dtype}")
    for name, t in (("weight", w), ("bias", b)):
        if t.dtype != torch.bfloat16 or t.device != x.device or tuple(t.shape) != (c,):
            raise ValueError(f"{what}: {name} ({c},) bf16 on {x.device} expected, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if not x.is_cuda:
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    x, w, b = lib.aligned16(x), lib.aligned16(w), lib.aligned16(b)
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    so = lib.load("layernorm")
    err = so.esr_layernorm(lib.ptr(x), lib.ptr(w), lib.ptr(b), lib.ptr(out), x.numel() // c, c, float(eps), sms,
                           lib.stream(x))
    lib.check(so, err, f"{what} launch")
    LAUNCHES.count += 1
    return out
