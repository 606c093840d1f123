"""Pipeline parallelism (GPipe) of the RRDB trunk (port of
esr_tpu/parallel/pipeline.py).

Stage s of a 'stage' axis of S ranks runs the trunk blocks ``s*nb/S ..
(s+1)*nb/S - 1`` (each RDB through the ``rdb5c`` kernel) on the microbatches
of the batch in a fill-drain schedule of ``n_micro + S - 1`` ticks: at tick t
stage s runs microbatch t - s, and hands its output to stage s + 1 for the
next tick (an ``all_gather`` of every stage's output and a local pick, where
JAX ppermutes it). The last stage's outputs are summed over the axis, so the
trunk's output is on every rank and the pre- and post-trunk layers run alike
everywhere. Bubble fraction (S-1)/(M+S-1); :func:`derive_n_micro` picks M.

The backward is the same schedule reversed (:class:`_Pipeline`): each stage
recomputes its blocks on the microbatch input it kept, backpropagates the
gradient the next stage handed it, and hands the input's gradient to the
previous stage. It is one autograd node, so every rank runs the same
collectives in the same order. Each stage's blocks get their gradients there;
a trainer sums them over the axis (``dp.GradSync``), so every rank keeps a
full copy of the generator and its optimiser state: the forward's work, not
the parameters' memory, is what the stages split.

The math is the sequential trunk's (the same blocks in the same order;
microbatching only splits the batch), and the ``all_layers`` Z of each
microbatch is taken by every stage from the replicated Z.
"""

from __future__ import annotations

import logging

import torch

from esr_tpu_torch.parallel import comm
from esr_tpu_torch.parallel.common import check_trunk_parallel_model, make_outer_apply
from esr_tpu_torch.parallel.mesh import make_stage_mesh

__all__ = [
    "derive_n_micro",
    "make_stage_mesh",
    "pipelined_rrdb_apply",
    "pipelined_rrdb_apply_auto",
    "pipelined_trunk",
    "stage_blocks",
]

_micro_warned: set = set()


def derive_n_micro(batch_size: int, n_stages: int, requested=None) -> int:
    """The GPipe microbatch count for a batch: ``requested`` when it divides
    the batch, else the largest divisor below it (logged); unset, the
    smallest divisor of the batch >= 4 * n_stages, or the whole batch when it
    is smaller. Warns once per batch size when forced to 1 over several stages."""
    b = int(batch_size)
    s = max(1, int(n_stages))
    log = logging.getLogger("base")
    if requested:
        m = min(int(requested), b)
        while b % m:
            m -= 1
        if m != int(requested) and ("req", b, int(requested)) not in _micro_warned:
            _micro_warned.add(("req", b, int(requested)))
            log.info(f"pp: requested n_micro={requested} does not divide batch={b}; using {m}")
    else:
        target = 4 * s
        m = b if b <= target else next((d for d in range(target, b + 1) if b % d == 0), b)
    if m == 1 and s > 1 and ("bubble", b) not in _micro_warned:
        _micro_warned.add(("bubble", b))
        log.warning(f"pp: batch={b} forces n_micro=1 over {s} stages — the GPipe bubble idles {s - 1}/{s} of "
                    "the pipeline; batch more images per forward (eval_batch) to amortize the fill/drain")
    return m


class _Schedule:
    """The fill-drain schedule of one call: ``stage_fn(x, z) -> y`` runs this
    rank's blocks on one microbatch (``z``: its Z, or None)."""

    def __init__(self, stage_fn, group: comm.Group, n_micro: int):
        self.stage_fn, self.group, self.m = stage_fn, group, n_micro

    def forward(self, x: torch.Tensor, z: torch.Tensor | None):
        s, n_stages, m = self.group.index, self.group.size, self.m
        xs = x.chunk(m)
        zs = [None] * m if z is None else z.chunk(m)
        outs, inputs, state = [None] * m, {}, None
        for t in range(m + n_stages - 1):
            j = t - s
            if 0 <= j < m:
                inputs[j] = xs[j] if s == 0 else state
                y = self.stage_fn(inputs[j], zs[j])
                if s == n_stages - 1:
                    outs[j] = y
            else:  # a bubble: nothing to run, zeros to hand over
                y = torch.zeros_like(xs[0])
            if t < m + n_stages - 2:
                handed = comm.gather_list(y, self.group)
                state = handed[s - 1] if s > 0 else None
        out = torch.cat(outs) if s == n_stages - 1 else torch.zeros_like(x)
        return comm.reduce(out, self.group), inputs

    def backward(self, inputs: dict, x: torch.Tensor, z: torch.Tensor | None, grad_out: torch.Tensor,
                 params: list, needs: tuple):
        s, n_stages, m = self.group.index, self.group.size, self.m
        gys = grad_out.chunk(m)
        zs = [None] * m if z is None else z.chunk(m)
        g_x = [torch.zeros_like(c) for c in x.chunk(m)]
        g_z = None if z is None else [torch.zeros_like(c) for c in zs]
        g_p = [torch.zeros_like(p) for p in params]
        state = None
        for t in range(m + n_stages - 1):
            j = t - (n_stages - 1 - s)
            if 0 <= j < m:
                gy = gys[j] if s == n_stages - 1 else state
                with torch.enable_grad():
                    xin = inputs[j].detach().requires_grad_()
                    zin = None if zs[j] is None else zs[j].detach().requires_grad_(needs[1])
                    wanted = [xin] + ([zin] if needs[1] else []) + list(params)
                    grads = torch.autograd.grad(self.stage_fn(xin, zin), wanted, gy, allow_unused=True)
                g_in = grads[0]
                if needs[1] and grads[1] is not None:
                    g_z[j] += grads[1]
                for acc, g in zip(g_p, grads[1 + int(needs[1]):]):
                    if g is not None:
                        acc += g
                if s == 0:
                    g_x[j] = g_in
            else:
                g_in = torch.zeros_like(g_x[0])
            if t < m + n_stages - 2:
                handed = comm.gather_list(g_in, self.group)
                state = handed[s + 1] if s < n_stages - 1 else None
        # the input fed stage 0 only, every stage used the Z: sums over the axis
        gx = comm.reduce(torch.cat(g_x), self.group)
        gz = None if z is None else comm.reduce(torch.cat(g_z), self.group)
        return gx, gz, g_p


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, z, *params):
        out, inputs = sched.forward(x, z)
        ctx.sched, ctx.inputs, ctx.params = sched, inputs, params
        ctx.save_for_backward(x, z)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, z = ctx.saved_tensors
        gx, gz, gp = ctx.sched.backward(ctx.inputs, x, z, grad_out, ctx.params, ctx.needs_input_grad[1:3])
        return (None, gx, gz, *gp)


def pipelined_trunk(stage_fn, stage_params: list, mesh, n_micro: int, axis: str = "stage"):
    """``fn(carry) -> carry`` running ``stage_fn(x, z) -> y`` (this rank's
    blocks on a microbatch) as a GPipe pipeline over ``axis``. ``carry``: the
    trunk features (B, H, W, nf), or ``(trunk, z)`` whose Z each stage uses
    unchanged. ``stage_params``: the parameters ``stage_fn`` reads (they get
    their gradients). B must divide by ``n_micro``."""
    group = mesh.group(axis)

    def trunk(carry):
        x, z = carry if isinstance(carry, tuple) else (carry, None)
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} does not divide into {n_micro} microbatches")
        sched = _Schedule(stage_fn, group, n_micro)
        params = [p for p in stage_params if p.requires_grad]
        if torch.is_grad_enabled() and (x.requires_grad or params or (z is not None and z.requires_grad)):
            y = _Pipeline.apply(sched, x, z, *params)
        else:
            y = sched.forward(x, z)[0]
        return (y, z) if isinstance(carry, tuple) else y

    return trunk


def stage_blocks(model, mesh, axis: str = "stage") -> range:
    """The trunk blocks this rank's stage runs."""
    n_stages = mesh.shape[axis]
    nb = len(model.RRDB_trunk)
    if nb % n_stages:
        raise ValueError(f"nb={nb} not divisible by {n_stages} stages")
    k = nb // n_stages
    s = mesh.index(axis)
    return range(s * k, (s + 1) * k)


def _stage_fn(model, blocks: range):
    if model.all_layers:
        return lambda x, z: model.run_blocks((x, z), blocks)[0]
    return lambda x, z: model.run_blocks(x, blocks)


def _stage_params(model, blocks: range) -> list:
    mods = [model.RRDB_trunk[i] for i in blocks]
    if model.all_layers:
        mods += [model.latent_proj[i] for i in blocks]
    return [p for mod in mods for p in mod.parameters()]


def pipelined_rrdb_apply(model, mesh, n_micro: int, axis: str = "stage"):
    """``fn(lr, z=None) -> sr``: ``model``'s forward with the trunk pipelined
    over ``axis`` in ``n_micro`` microbatches; the pre- and post-trunk layers
    run alike on every stage. Requires ``nb % S == 0``."""
    check_trunk_parallel_model(model, "pipelined_rrdb_apply")
    blocks = stage_blocks(model, mesh, axis)
    return make_outer_apply(model, pipelined_trunk(_stage_fn(model, blocks), _stage_params(model, blocks), mesh,
                                                   n_micro, axis))


def pipelined_rrdb_apply_auto(model, mesh, requested=None, axis: str = "stage"):
    """:func:`pipelined_rrdb_apply` with the microbatch count of each call's
    batch from :func:`derive_n_micro` (one wrapper per count, kept)."""
    check_trunk_parallel_model(model, "pipelined_rrdb_apply")
    stage_blocks(model, mesh, axis)
    n_stages = mesh.shape[axis]
    cache: dict = {}

    def apply(lr, z=None):
        m = derive_n_micro(lr.shape[0], n_stages, requested)
        if m not in cache:
            cache[m] = pipelined_rrdb_apply(model, mesh, n_micro=m, axis=axis)
        return cache[m](lr, z)

    return apply
