"""Named device meshes over the ranks of the process group (port of
esr_tpu/parallel/mesh.py and of the mesh makers of tensor.py and pipeline.py).

A mesh lays named axes over the world's ranks, row-major (the last axis
varies fastest), and builds one process group for every line of every axis.
A world larger than the mesh holds further copies of it (ranks ``n .. 2n-1``
form the second, and so on), which compute the same; a world that is not a
multiple of the mesh raises, as a mesh larger than the world does. Building a
mesh is collective: every rank of the world builds the same meshes in the
same order.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from esr_tpu_torch.parallel.comm import SOLO, Group, world

__all__ = ["Mesh", "make_mesh", "make_spatial_tp_mesh", "make_stage_mesh", "make_tp_mesh"]


class Mesh:
    """Axes ``names`` of ``sizes`` over the world. ``shape`` maps each name to
    its size; ``group(name)`` is this rank's :class:`Group` along that axis;
    ``index(name)`` this rank's coordinate there."""

    def __init__(self, names: tuple[str, ...], sizes: tuple[int, ...]):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        rank, n_world = world()
        if self.size > n_world or n_world % self.size:
            raise ValueError(f"mesh of {self.size} ranks ({_describe(self.shape)}) but the process group "
                             f"has {n_world}: it must be a multiple of the mesh")
        self.rank = rank
        self.coords = self._coords(rank)
        self._groups = {}
        for name in names:
            if self.shape[name] == 1:
                self._groups[name] = SOLO
                continue
            lines: dict[tuple, list[int]] = {}  # ranks differing only in this axis, per copy of the mesh
            for r in range(n_world):
                c = self._coords(r)
                lines.setdefault((r // self.size,) + tuple(c[m] for m in names if m != name), []).append(r)
            for ranks in lines.values():
                pg = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[name] = Group(len(ranks), ranks.index(rank), pg)

    def _coords(self, rank: int) -> dict[str, int]:
        out, i = {}, rank % self.size
        for name in reversed(self.axis_names):
            out[name] = i % self.shape[name]
            i //= self.shape[name]
        return out

    def group(self, name: str) -> Group:
        return self._groups[name] if name in self._groups else SOLO

    def index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def __repr__(self) -> str:
        return f"Mesh({_describe(self.shape)})"


def _describe(shape: dict) -> str:
    return " x ".join(f"{n} {s}" for n, s in shape.items())


def make_mesh(n_devices: int | None = None, data: int | None = None, spatial: int = 1) -> Mesh:
    """A ('data', 'spatial') mesh over ``n_devices`` ranks (the world's by default)."""
    n_world = world()[1]
    n = n_devices or n_world
    if n > n_world:
        raise ValueError(
            f"mesh needs {n} ranks (data {data} x spatial {spatial}) but only {n_world} are in the process "
            "group — shrink the shard counts or launch more ranks (torchrun --nproc_per_node N)")
    data = data or (n // spatial)
    if data < 1 or data * spatial != n:
        raise ValueError(f"data({data}) x spatial({spatial}) != devices({n})")
    return Mesh(("data", "spatial"), (data, spatial))


def make_tp_mesh(n_shards: int | None = None, data: int = 1) -> Mesh:
    """A ('model',) mesh for channel tensor parallelism or, with ``data`` > 1,
    a ('data', 'model') mesh (batch over 'data', channels over 'model')."""
    n_world = world()[1]
    n = n_shards or n_world // data
    if n < 1 or data < 1 or n * data > n_world:
        raise ValueError(f"asked for {data}x{n} (data x model) shards but only {n_world} ranks are "
                         "available — launch more ranks (torchrun --nproc_per_node N)")
    if data > 1:
        return Mesh(("data", "model"), (data, n))
    return Mesh(("model",), (n,))


def make_spatial_tp_mesh(spatial: int, tp: int) -> Mesh:
    """A ('spatial', 'model') mesh for the composed spatial x TP forward."""
    n_world = world()[1]
    if spatial < 1 or tp < 1 or spatial * tp > n_world:
        raise ValueError(f"asked for {spatial}x{tp} (spatial x model) shards but only {n_world} ranks are "
                         "available — launch more ranks (torchrun --nproc_per_node N)")
    return Mesh(("spatial", "model"), (spatial, tp))


def make_stage_mesh(n_stages: int | None = None) -> Mesh:
    """A ('stage',) mesh for pipelining."""
    n_world = world()[1]
    n = n_stages or n_world
    if n > n_world:
        raise ValueError(f"asked for {n} stages but only {n_world} ranks are available — launch more "
                         "ranks (torchrun --nproc_per_node N)")
    return Mesh(("stage",), (n,))
