"""Process groups, the rank's device, and the collectives of the parallel axes.

The JAX package drives every device from one process and lets ``shard_map``
place ``lax.psum``, ``all_gather`` and ``ppermute``. The port runs one process
per device (``torchrun``, or :func:`spawn`), and these are its collectives.
Only ``all_reduce`` and ``all_gather`` are used: gloo runs both on CUDA tensors
(through host memory) and on CPU tensors, NCCL on CUDA tensors. A ring
exchange (``ppermute``) is an ``all_gather`` of the boundary slab and a local
pick. The backend is explicit (``dist_backend``; NCCL for CUDA and gloo for the
CPU by default) and a collective the backend cannot run on a tensor's device
raises: nothing is copied to the host behind the caller's back.

Gradients follow ``shard_map``'s rule: every rank of a group computes the same
loss, and ``backward`` gives each rank the true gradient of the values it
holds. So:

- :func:`reduce` (``psum``) sums over the group; its output is used alike on
  every rank, so its backward is the identity;
- :func:`fan_out` is the identity; a replicated tensor that each rank then
  uses for a part of its own (a channel slice, a window, a stage's input)
  gets the sum of the ranks' gradients;
- :func:`gather` concatenates every rank's tensor; its output is used alike
  on every rank, so its backward is this rank's slice of the gradient.

Parameters replicated over ranks that each use them on their own part of the
data get the same treatment as :func:`fan_out`, once per step, in
``parallel/dp.py::GradSync``. Every rank must run the same collectives in the
same order, backward included: the parallel paths keep their graphs alike on
every rank.
"""

from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.distributed as dist

from esr_tpu_torch.device import resolve_device

__all__ = [
    "Group",
    "any_rank",
    "broadcast_from",
    "fan_out",
    "gather",
    "gather_list",
    "init_from_env",
    "init_process_group",
    "rank_device",
    "reduce",
    "spawn",
    "world",
]


@dataclass(frozen=True)
class Group:
    """The ranks of one mesh axis that hold this rank: their process group
    (None for a group of one), its size and this rank's index in it."""

    size: int = 1
    index: int = 0
    pg: object = field(default=None, compare=False, repr=False)


SOLO = Group()


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_process_group(backend: str | None = None, init_method: str = "env://", world_size: int | None = None,
                       rank: int | None = None, device: str | torch.device = "cuda") -> tuple[int, int]:
    """Join the default process group. ``backend``: ``nccl`` (CUDA ranks, one
    GPU each) or ``gloo`` (CPU ranks, or CUDA ranks sharing GPUs; its
    collectives on CUDA tensors go through host memory); by default NCCL for
    a CUDA ``device`` and gloo for the CPU. Returns (rank, world size)."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("dist_backend nccl runs CUDA tensors only; use gloo for CPU ranks")
    kw = {} if world_size is None else {"world_size": int(world_size), "rank": int(rank)}
    dist.init_process_group(backend, init_method=init_method, **kw)
    return world()


def rank_device(device: str | torch.device = "cuda", gpu_ids=None) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` over the visible GPUs (capped
    by ``gpu_ids``), ranks sharing GPUs round-robin when there are more ranks
    than GPUs (gloo only: NCCL refuses two ranks on one GPU); the device as
    given when it names an index or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if gpu_ids:
        n = min(n, len(gpu_ids))
    rank, size = world()
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    if size > 1 and local_size > n and dist.get_backend() == "nccl":
        raise ValueError(f"{local_size} ranks on this host share {n} GPU(s): NCCL needs a GPU per rank — "
                         "set dist_backend: gloo to put several ranks on one GPU")
    return torch.device("cuda", local % n)


def init_from_env(opt: dict, device: str | torch.device = "cuda") -> torch.device:
    """The entry points' process group: joined from the launcher's environment
    (``torchrun`` sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``) when
    ``WORLD_SIZE`` > 1, with the options' ``dist_backend``. Returns the rank's
    device (:func:`rank_device`)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not (dist.is_available() and dist.is_initialized()):
        init_process_group(opt.get("dist_backend"), device=device)
    return rank_device(device, opt.get("gpu_ids"))


def _check(x: torch.Tensor, g: Group, what: str) -> None:
    if g.pg is not None and dist.get_backend(g.pg) == "nccl" and not x.is_cuda:
        raise RuntimeError(f"{what}: the nccl backend cannot run a collective on a {x.device} tensor")


def _all_reduce(x: torch.Tensor, g: Group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if g.size == 1:
        return x
    _check(x, g, "all_reduce")
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=g.pg)
    return y


def _all_gather(x: torch.Tensor, g: Group) -> list[torch.Tensor]:
    if g.size == 1:
        return [x]
    _check(x, g, "all_gather")
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(g.size)]
    dist.all_gather(out, x, group=g.pg)
    return out


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim, ctx.n = g, dim, x.shape[dim]
        return torch.cat(_all_gather(x, g), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.g.index * ctx.n, ctx.n), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce(x: torch.Tensor, g: Group) -> torch.Tensor:
    """Sum of ``x`` over the group (``lax.psum``); backward: the identity."""
    if g.size == 1:
        return x
    return _Reduce.apply(x, g) if _tracked(x) else _all_reduce(x, g)


def fan_out(x: torch.Tensor, g: Group) -> torch.Tensor:
    """``x``; backward: the sum of the ranks' gradients (see the module docstring)."""
    return _FanOut.apply(x, g) if g.size > 1 and _tracked(x) else x


def gather(x: torch.Tensor, g: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order
    (``all_gather(..., tiled=True)``); backward: this rank's slice."""
    if g.size == 1:
        return x
    return _Gather.apply(x, g, dim) if _tracked(x) else torch.cat(_all_gather(x, g), dim=dim)


def gather_list(x: torch.Tensor, g: Group) -> list[torch.Tensor]:
    """Every rank's ``x``, in group order, without autograd (results, metrics)."""
    return _all_gather(x.detach(), g)


def broadcast_from(x: torch.Tensor, src: int, g: Group) -> torch.Tensor:
    """The group member ``src``'s ``x`` on every rank (an ``all_reduce`` of
    ``x`` on ``src`` and zeros elsewhere), without autograd."""
    if g.size == 1:
        return x
    x = x.detach()
    return _all_reduce(x if g.index == src else torch.zeros_like(x), g)


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank of the world, the same answer on
    every rank; the flag itself without a process group. Collective. An
    ``all_reduce`` MAX of a CPU tensor over gloo (the world's group, or a gloo
    group of the world made at the first call under NCCL): it waits for the
    peers' flags, not for the device work that the rank has queued."""
    rank, size = world()
    if size == 1:
        return bool(flag)
    x = torch.tensor([float(bool(flag))])
    return bool(_all_reduce(x, Group(size, rank, _host_group()), op=dist.ReduceOp.MAX).item())


_HOST_GROUP: list = [None, None]  # [the default group it serves, a gloo group of the world]


def _host_group():
    """A process group of the world that runs CPU tensors: None (the default
    group) under gloo, else a gloo group made once per default group."""
    if dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP[0] is not dist.group.WORLD:
        _HOST_GROUP[:] = [dist.group.WORLD, dist.new_group(backend="gloo")]
    return _HOST_GROUP[1]


def _child(rank: int, world_size: int, store: str, backend: str, threads: int, fn, args, out: str) -> None:
    try:
        torch.set_num_threads(threads)
        init_process_group(backend, init_method=f"file://{store}", world_size=world_size, rank=rank,
                           device="cpu" if backend == "gloo" else "cuda")
        try:
            result = {"ok": fn(*args)}
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        result = {"error": traceback.format_exc()}
    torch.save(result, out)


def spawn(fn, world_size: int, workdir: str | os.PathLike, args: tuple = (), backend: str = "gloo",
          timeout: float = 120.0, threads: int = 2) -> list:
    """Run ``fn(*args)`` on ``world_size`` new processes (``spawn`` start), each
    rank in a process group of ``backend`` over a file store in ``workdir``;
    returns the ranks' results in rank order. ``fn`` must be importable by
    name. A rank that raises, or a run past ``timeout`` seconds (every rank is
    then killed), raises here."""
    import multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / f"store_{os.getpid()}_{time.monotonic_ns()}"
    outs = [workdir / f"{store.name}_rank{r}.pt" for r in range(world_size)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, world_size, str(store), backend, threads, fn, args, str(outs[r])))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} still running after {timeout:.0f} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    results, errors = [], []
    for r, path in enumerate(outs):
        if not path.exists():
            errors.append(f"rank {r}: exited with code {procs[r].exitcode} and no result")
            continue
        res = torch.load(path, weights_only=False)
        path.unlink()
        if "error" in res:
            errors.append(f"rank {r}:\n{res['error']}")
        results.append(res.get("ok"))
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
