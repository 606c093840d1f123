"""Training preprocessing on the device (port of esr_tpu/data/pipeline.py).

The host hands over stacked HR crops (uint8 or float, NHWC); ``pipe`` then
normalises them, augments with one of the 8 flip/rot90 symmetries per sample
(or a subgroup of them), synthesises the LR (an optional extra blur, then
MATLAB bicubic ``imresize``, or ``downsample_fn`` for a custom kernel) and
draws the Z map. Random numbers (augment codes, Z) come from a
``torch.Generator`` on the CPU, so a run draws the same numbers on every
device; the JAX package's ``jax.random`` draws are other numbers from the
same seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.resize import imresize
from esr_tpu_torch.utils.profiler import annotate

__all__ = ["augment_codes", "dihedral_transform", "draw_z", "make_train_pipeline"]

_ROT_CODES = (0, 2, 4, 5)  # rot-only subgroup {I, V, T, T.V}: data/util.py augment without hflip


def dihedral_transform(img: torch.Tensor, code: int) -> torch.Tensor:
    """Apply one of the 8 flip/rot90 symmetries to an HWC image (square for
    codes 4-7, which transpose): 0 identity, 1 hflip, 2 vflip, 3 both, 4
    transpose, 5-7 transpose then 1-3."""
    if code >= 4:
        img = img.transpose(0, 1)
    dims = {0: (), 1: (1,), 2: (0,), 3: (0, 1)}[int(code) % 4]
    return img.flip(dims) if dims else img


def draw_z(gen: torch.Generator, shape, kind: str = "uniform") -> torch.Tensor:
    """Random latent Z map in [-1, 1] on the CPU (per-step draw for
    explorable training)."""
    if kind == "uniform":
        return torch.rand(shape, generator=gen) * 2.0 - 1.0
    if kind == "normal":
        return torch.randn(shape, generator=gen)
    if kind == "zeros":
        return torch.zeros(shape)
    raise ValueError(kind)


def augment_codes(gen: torch.Generator, n: int, use_flip: bool, use_rot: bool) -> list[int]:
    """One dihedral code per sample from the augment subgroup: all 8 with flip
    and rot, {I, hflip} with flip only, {I, V, T, T.V} with rot only, {I}
    with neither."""
    if use_flip and use_rot:
        return torch.randint(0, 8, (n,), generator=gen).tolist()
    if use_flip:
        return torch.randint(0, 2, (n,), generator=gen).tolist()
    if use_rot:
        return [_ROT_CODES[i] for i in torch.randint(0, 4, (n,), generator=gen).tolist()]
    return [0] * n


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise SAME correlation with a 2-D kernel (XLA's SAME padding:
    (k - 1) // 2 before, the rest after), NHWC."""
    c = x.shape[-1]
    kh, kw = kernel.shape
    xc = F.pad(x.permute(0, 3, 1, 2), ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    w = kernel.to(x)[None, None].expand(c, 1, kh, kw)
    return F.conv2d(xc, w, groups=c).permute(0, 2, 3, 1)


def make_train_pipeline(scale: int = 4, use_flip: bool = True, use_rot: bool = True, blur_kernel=None,
                        num_latent_channels: int = 0, z_kind: str = "uniform", downsample_fn=None):
    """``pipe(hr_batch, gen, codes=None, shard=None) -> {'HR', 'LR'[, 'Z']}``
    (f32 NHWC on the batch's device).

    ``hr_batch``: (N, H, W, C) uint8 or float [0, 1], or a dict ``{'HR',
    'LR'}`` of paired crops: the given LR is used as it is, augmented with
    the same code as its HR, and no LR is synthesised. ``codes``: the
    dihedral code of each sample; drawn from ``gen`` (then Z) when None.
    ``downsample_fn`` replaces the bicubic LR synthesis (``cem.downsample``
    for a custom kernel); ``blur_kernel`` blurs before the bicubic instead.
    ``shard=(i, n)``: ``hr_batch`` is rank i's rows i*N .. (i+1)*N - 1 of a
    global batch of n*N (data parallelism): the codes and Z are drawn for the
    global batch and this rank keeps its rows, so the draws are those of one
    process running the global batch."""
    blur = None if blur_kernel is None else torch.as_tensor(blur_kernel, dtype=torch.float32)

    def pipe(hr_batch, gen: torch.Generator, codes=None, shard=None) -> dict:
        lr_in = None
        if isinstance(hr_batch, dict):
            lr_in = hr_batch.get("LR")
            hr_batch = hr_batch["HR"]
        hr = _norm(hr_batch)
        n = hr.shape[0]
        i, n_shards = shard or (0, 1)
        rows = slice(i * n, (i + 1) * n)
        if use_rot and hr.shape[1] != hr.shape[2]:
            raise ValueError(f"use_rot requires square train crops, got {hr.shape[1]}x{hr.shape[2]} "
                             "— set use_rot: false for non-square crops")
        if codes is None:
            codes = augment_codes(gen, n * n_shards, use_flip, use_rot)[rows]
        codes = [int(c) for c in codes]
        if any(codes):
            hr = torch.stack([dihedral_transform(hr[i], c) for i, c in enumerate(codes)])
            if lr_in is not None:
                lr_in = _norm(lr_in)
                lr_in = torch.stack([dihedral_transform(lr_in[i], c) for i, c in enumerate(codes)])
        if lr_in is not None:
            lr = _norm(lr_in)
        else:
            src = hr if blur is None else _blur(hr, blur)
            lr = downsample_fn(src) if downsample_fn is not None else imresize(src, scale=1.0 / scale)
        out = {"HR": hr, "LR": lr}
        if num_latent_channels:
            shape = (n * n_shards,) + tuple(lr.shape[1:-1]) + (num_latent_channels,)
            z = draw_z(gen, shape, z_kind)[rows]
            with annotate("pipeline.upload", waits=True):  # a copy from pageable memory: it waits for the stream
                out["Z"] = z.to(lr.device)
        return out

    return pipe
