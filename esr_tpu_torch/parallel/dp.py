"""Data parallelism over the ranks of a mesh's 'data' axis (port of
esr_tpu/parallel/dp.py).

The JAX step is one SPMD program over the global batch: it computes exactly
the single-device function of that batch. The port's data-parallel step does
the same with one process per rank:

- each rank takes its rows of the global batch (:func:`shard_batch`); the
  random draws (augment codes, Z, the WGAN-GP weights) are made for the
  global batch from the one generator and each rank keeps its rows;
- every batch mean is a global mean (:meth:`BatchComm.mean`), and so are the
  batch statistics used inside the step (BatchNorm's, RaGAN's mean logits:
  :meth:`BatchComm.stat_mean`), so every rank computes the global loss;
- :class:`GradSync` sums each parameter's gradients over the ranks that use
  it on their own rows (and averages them over ranks that compute it alike),
  before the optimiser's global-norm clip, so replicated states stay
  identical on every rank; Adam's global-norm clip reads the norm of the
  whole gradient (:meth:`GradSync.sq_sum`), a channel-sharded trunk's
  slices included.

JAX's chunked form (``batch_dim=1``, ``steps_per_dispatch``): the train
loop groups the same chunks, and with several ranks each step of a chunk
runs alone and eagerly. One process replays a CUDA graph of the step
(``utils/graphs.py``); several do not, because gloo's collectives cannot be
captured and a capture under NCCL has not been checked.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from esr_tpu_torch.parallel import comm
from esr_tpu_torch.parallel.comm import SOLO, Group

__all__ = ["BatchComm", "GradSync", "StepParallel", "batch_sharding", "make_dp_train_step", "replicated", "shard_batch"]


def _leaves(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _leaves(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _leaves(v)
    else:
        yield batch


def _check_divisible(batch, n_data: int, dim: int = 0) -> None:
    for leaf in _leaves(batch):
        shape = getattr(leaf, "shape", None)
        if not shape or len(shape) <= dim:  # scalars have no batch dim
            continue
        n = shape[dim]
        if n is not None and n % n_data:
            raise ValueError(f"batch dim {n} does not divide the {n_data}-device 'data' axis — use a "
                             "divisible batch size")


def _rows(x, index: int, size: int):
    if isinstance(x, dict):
        return {k: _rows(v, index, size) for k, v in x.items()}
    if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim:
        n = x.shape[0] // size
        return x[index * n : (index + 1) * n]
    return x


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of a global batch (a tensor, an array or a dict of
    them): rows ``i * B/n .. (i + 1) * B/n`` for index ``i`` of ``n`` on ``axis``."""
    g = mesh.group(axis)
    _check_divisible(batch, g.size)
    return _rows(batch, g.index, g.size)


def batch_sharding(mesh, axis: str = "data"):
    """The placement of a batch over ``axis``: a function from the global batch
    to this rank's rows (:func:`shard_batch`)."""
    return lambda batch: shard_batch(batch, mesh, axis)


def replicated(mesh):
    """The replicated placement: a function that makes every rank of the mesh
    hold the first rank's value of a tensor (each axis in turn)."""

    def place(x: torch.Tensor) -> torch.Tensor:
        for name in mesh.axis_names:
            x = comm.broadcast_from(x, 0, mesh.group(name))
        return x

    return place


class BatchComm:
    """Means over a batch sharded on ``group`` (equal rows per rank). Without a
    group (``SOLO``) they are the local means."""

    def __init__(self, group: Group = SOLO):
        self.group = group

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean of a quantity averaged over the batch: a loss, a
        metric. Used alike on every rank (backward: the identity)."""
        m = torch.mean(x)
        return m if self.group.size == 1 else comm.reduce(m, self.group) / self.group.size

    def stat_mean(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        """The global mean over the batch of a statistic that each rank then
        applies to its own rows (BatchNorm's moments, RaGAN's mean logit)."""
        m = torch.mean(x) if dim is None else torch.mean(x, dim=dim)
        if self.group.size == 1:
            return m
        return comm.fan_out(comm.reduce(m, self.group) / self.group.size, self.group)


class GradSync:
    """Reduce a step's gradients across ranks, one ``all_reduce`` per rule.
    ``rules``: (group, op) pairs, ``op`` "sum" (the ranks use the parameters
    on their own part of the work: their rows, their windows, the blocks a
    stage owns), "mean" (the ranks compute the gradient alike, so identical
    up to the last bit at most) or a function of the parameter's index giving
    one of them or None (leave it out: a channel shard on the TP axis)."""

    def __init__(self, rules=()):
        self.rules = [(g, op) for g, op in rules if g.size > 1]

    @torch.no_grad()
    def __call__(self, params: list, grads: list) -> list:
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        for group, op in self.rules:
            ops = [op(i) if callable(op) else op for i in range(len(grads))]
            by_dtype: dict[torch.dtype, list[int]] = {}
            for i, o in enumerate(ops):
                if o is not None:
                    by_dtype.setdefault(grads[i].dtype, []).append(i)
            for ids in by_dtype.values():
                # a mean is a sum of the ranks' values over the group size
                flat = torch.cat([(grads[i] / group.size if ops[i] == "mean" else grads[i]).reshape(-1) for i in ids])
                flat = comm.reduce(flat, group)
                for i, part in zip(ids, torch.split(flat, [grads[i].numel() for i in ids])):
                    grads[i] = part.view_as(grads[i])
        return grads

    @torch.no_grad()
    def sq_sum(self, grads: list) -> torch.Tensor:
        """The squared global norm of reduced gradients (Adam's clip): a
        gradient left out on a group (a channel shard) adds its squares summed
        over that group's ranks, the rest (alike on every rank) count once.
        The same on every rank."""
        sq = [torch.sum(g.float() ** 2) for g in grads]
        rest = list(range(len(grads)))
        total = 0.0
        for group, op in self.rules:
            shards = [i for i in rest if callable(op) and op(i) is None]
            if shards:
                total = total + comm.reduce(torch.stack([sq[i] for i in shards]).sum(), group)
                rest = [i for i in rest if i not in shards]
        return total + sum(sq[i] for i in rest)


def make_dp_train_step(loss_fn, params: list, apply_update, mesh, axis: str = "data", local_rows: bool = False):
    """A data-parallel train step over ``mesh``'s ``axis``: ``step(batch,
    *extras) -> loss`` takes the global batch, keeps this rank's rows (the
    batch is already those rows with ``local_rows``), computes ``loss_fn(rows, *extras, batch_comm)`` (which averages with
    ``batch_comm.mean``), sums the gradients of ``params`` over the axis and
    calls ``apply_update(grads)``. Every rank returns the global loss and
    holds the same parameters after the step."""
    group = mesh.group(axis)
    bc = BatchComm(group)
    sync = GradSync([(group, "sum")])

    def step(batch, *extras):
        with torch.enable_grad():
            rows = batch if local_rows else shard_batch(batch, mesh, axis)
            loss = loss_fn(rows, *extras, bc)
            grads = torch.autograd.grad(loss, params)
        apply_update(sync(params, list(grads)))
        return loss.detach()

    return step


@dataclass
class StepParallel:
    """What a trainer's step needs of the parallel axes: ``g_apply(lr, z)``,
    G's forward (None: the module itself), the batch's means (``batch``: over
    the 'data' axis), the gradient reductions of G and D, and the mesh (None:
    one device)."""

    mesh: object = None
    g_apply: object = None
    batch: BatchComm = field(default_factory=BatchComm)
    sync_g: GradSync = field(default_factory=GradSync)
    sync_d: GradSync = field(default_factory=GradSync)

    @property
    def shard(self) -> tuple[int, int]:
        """This rank's (index, count) on the batch's axis."""
        return self.batch.group.index, self.batch.group.size
