"""Spatial ("context") parallelism for large images (port of
esr_tpu/parallel/spatial.py).

LR height is split over a mesh's 'spatial' axis: each rank runs the generator
on its strip plus a halo of neighbouring rows and keeps its own output rows.
The generator's receptive field (23 RRDBs x 3 RDBs x 5 convs, ~700 px) makes
exact sharding impractical; the halo (32 LR px by default) bounds the seam
error, which decays through the 0.2-scaled residual blocks (the JAX package
measured its floor by halo 8 at flagship depth, bit-exact by 32).

- :func:`spatial_sharded_forward`: the ring variant. Halos come from the
  neighbouring strips (an ``all_gather`` of the boundary slabs and a local
  pick, where JAX ppermutes them) and the image edges are replicate-padded,
  so the first and last ~halo output rows differ from the whole-image
  forward's zero-padded SAME.
- :func:`spatial_window_forward`: exact edges. Each rank slices an in-image
  window ``clip([i*local - halo, i*local + local + halo)) -> [0, H]`` of the
  LR (every rank holds the whole LR; JAX all_gathers the strips to the same
  end) and crops its kept rows from the window's SR, so only interior seams
  carry the halo decay. Differentiable: the ``train_spatial`` forward.
- :func:`tiled_forward` (one device, fixed overlapping tiles, one global CEM
  projection) and :func:`spatial_fold_apply` (one device, H strips batched).

CEM: wrap the RAW generator and project the assembled output globally; a
per-strip projection would lose exactness at the seams.

Both distributed forwards take the whole LR (and Z) and return the whole SR
on every rank of the axis (the output rows are gathered, backward: each
rank's own rows). ``apply_fn(lr, z) -> sr`` is the raw generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esr_tpu_torch.parallel import comm
from esr_tpu_torch.parallel.dp import _check_divisible

__all__ = ["spatial_fold_apply", "spatial_sharded_forward", "spatial_window_forward", "tiled_forward"]


def _check_rows(h: int, n_shards: int, axis: str) -> None:
    if h % n_shards:
        raise ValueError(f"LR height {h} does not divide the {n_shards}-shard '{axis}' axis — pad the image "
                         "or change the mesh")


def spatial_fold_apply(apply_fn, fold: int, halo: int = 32, scale: int = 4):
    """Split each image into ``fold`` halo-overlapped H strips batched together
    (one device): the JAX package's way to fill a batch->channel fold at batch
    1. The port has no fold, so this only re-batches; strips are clipped to
    the true image (no padding), so the stitched output matches the
    whole-image forward up to the halo decay at the seams. Images too short
    to split (fewer than stride + halo rows per strip) and batches divisible
    by ``fold`` pass through unchanged."""

    def wrapped(lr, z=None):
        n, h = lr.shape[:2]
        f = int(fold)
        stride = -(-h // f)
        # f = 2: each strip needs the halo on its seam side only
        rows = stride + halo * (1 if f == 2 else 2)
        if f <= 1 or n % f == 0 or rows >= h:
            return apply_fn(lr, z)
        if f == 2:
            starts = [0, h - rows]
        else:
            starts = [min(max(s * stride - halo, 0), h - rows) for s in range(f)]
        keeps = [(s * stride, min((s + 1) * stride, h)) for s in range(f)]
        strips = torch.cat([lr[i : i + 1, st : st + rows] for i in range(n) for st in starts])
        zs = None if z is None else torch.cat([z[i : i + 1, st : st + rows] for i in range(n) for st in starts])
        raw = apply_fn(strips, zs)
        return torch.cat([
            torch.cat([raw[i * f + s, (k0 - st) * scale : (k1 - st) * scale]
                       for s, (st, (k0, k1)) in enumerate(zip(starts, keeps))])[None]
            for i in range(n)])

    return wrapped


def spatial_sharded_forward(apply_fn, mesh, scale: int = 4, halo: int = 32, axis: str = "spatial"):
    """``fwd(lr, z=None) -> sr`` with LR height sharded over ``axis``: each rank
    takes its strip, gets ``halo`` rows from each neighbouring strip (the
    ring), replicate-pads at the image edges, runs ``apply_fn`` and keeps its
    rows. LR height must divide the axis and the halo fit a strip."""
    g = mesh.group(axis)
    n_shards = g.size

    def _validate(lr):
        if halo < 1:
            raise ValueError(
                f"halo must be >= 1 for the sharded forward (got {halo}); halo=0 seam-error measurement is "
                "supported on the batched spatial_fold_apply path, not here (the ring exchange and output "
                "crop degenerate at 0)")
        h = lr.shape[1]
        _check_rows(h, n_shards, axis)
        local = h // n_shards
        if halo > local:
            raise ValueError(f"halo {halo} exceeds the local strip height {local} ({h}px / {n_shards} shards) "
                             "— shrink the halo or the mesh")

    def extend(x):
        local = x.shape[1] // n_shards
        idx = g.index
        strip = comm.fan_out(x, g)[:, idx * local : (idx + 1) * local]
        # the ring: every rank's top and bottom slabs, gathered; each picks its neighbours'
        slabs = comm.fan_out(comm.gather(torch.cat([strip[:, :halo], strip[:, -halo:]], dim=1)[None], g), g)
        top = strip[:, :1].expand(-1, halo, -1, -1) if idx == 0 else slabs[idx - 1, :, halo:]
        bot = strip[:, -1:].expand(-1, halo, -1, -1) if idx == n_shards - 1 else slabs[idx + 1, :, :halo]
        return torch.cat([top, strip, bot], dim=1)

    def fwd(lr, z=None):
        _validate(lr)
        sr = apply_fn(extend(lr), None if z is None else extend(z))
        return comm.gather(sr[:, halo * scale : -halo * scale], g, dim=1)

    return fwd


def spatial_window_forward(apply_fn, mesh, scale: int = 4, halo: int = 32, axis: str = "spatial",
                           data_axis: str | None = None):
    """``fwd(lr, z=None) -> sr`` with exact edges (see the module docstring).
    Requires ``H % S == 0`` and ``2*halo <= H/S``.

    ``data_axis``: the batch is also sharded over that axis (DP x spatial):
    each rank runs its rows and the output is gathered over both axes.
    Parameters are replicated, so their gradients are summed over both axes
    (``dp.GradSync``); every saved activation is window-local, 1/S per rank:
    spatial is the axis that shards training activation memory."""
    g = mesh.group(axis)
    dg = mesh.group(data_axis) if data_axis else comm.SOLO
    n_shards = g.size
    if n_shards == 1:
        # one shard: the window is the whole image, and the halo only feeds seams
        halo = 0

    def _validate(lr):
        if halo < 0:
            raise ValueError("halo must be >= 0")
        h = lr.shape[1]
        _check_rows(h, n_shards, axis)
        if 2 * halo > h // n_shards:
            raise ValueError(f"2*halo ({2 * halo}) exceeds the local strip height {h // n_shards} ({h}px / "
                             f"{n_shards} shards) — shrink the halo or the mesh")

    def window(x, start: int, rows: int):
        if x is None:
            return None
        if dg.size > 1:
            n = x.shape[0] // dg.size
            x = comm.fan_out(x, dg)[dg.index * n : (dg.index + 1) * n]
        return comm.fan_out(x, g)[:, start : start + rows]

    def fwd(lr, z=None):
        _validate(lr)
        _check_divisible(lr, dg.size)
        h = lr.shape[1]
        local = h // n_shards
        rows = local + 2 * halo
        start = min(max(g.index * local - halo, 0), h - rows)
        sr = apply_fn(window(lr, start, rows), window(z, start, rows))
        keep = (g.index * local - start) * scale
        return comm.gather(comm.gather(sr[:, keep : keep + local * scale], g, dim=1), dg, dim=0)

    return fwd


def tiled_forward(apply_fn, lr: torch.Tensor, z: torch.Tensor | None = None, tile: int = 128,
                  overlap: int = 16, scale: int = 4, cem=None) -> torch.Tensor:
    """Large-image inference on one device: fixed-shape overlapping LR tiles
    (edge-padded to whole tiles), each tile's interior stitched at HR into an
    f32 image, then one exact CEM projection over the whole image."""
    n, h, w, c = lr.shape
    step = tile - 2 * overlap
    if step <= 0:
        raise ValueError("tile must exceed 2*overlap")
    pad_h = (-(h - tile) % step) if h > tile else tile - h
    pad_w = (-(w - tile) % step) if w > tile else tile - w

    def pad(x):  # NHWC edge padding: overlap before, overlap + pad after
        x = F.pad(x.permute(0, 3, 1, 2), (overlap, overlap + pad_w, overlap, overlap + pad_h), mode="replicate")
        return x.permute(0, 2, 3, 1)

    lr_p = pad(lr)
    z_p = None if z is None else pad(z)
    out = torch.zeros((n, (h + pad_h) * scale, (w + pad_w) * scale, c), dtype=torch.float32, device=lr.device)
    # starts clamped so that a tile and its update fit, as XLA's dynamic slices clamp them
    for y in range(0, h + pad_h, step):
        for x in range(0, w + pad_w, step):
            ty, tx = min(y, lr_p.shape[1] - tile), min(x, lr_p.shape[2] - tile)
            sr_t = apply_fn(lr_p[:, ty : ty + tile, tx : tx + tile],
                            None if z_p is None else z_p[:, ty : ty + tile, tx : tx + tile])
            inner = sr_t[:, overlap * scale : (tile - overlap) * scale, overlap * scale : (tile - overlap) * scale]
            oy = min(y * scale, out.shape[1] - inner.shape[1])
            ox = min(x * scale, out.shape[2] - inner.shape[2])
            out[:, oy : oy + inner.shape[1], ox : ox + inner.shape[2]] = inner.float()
    out = out[:, : h * scale, : w * scale]
    if cem is not None:
        out = cem.project(out, lr)
    return out
