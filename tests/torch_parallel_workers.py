"""The rank side of the parallel-axes tests (tests/test_torch_parallel*.py,
tests/test_torch_multihost.py): functions that ``comm.spawn`` runs on each
rank of a gloo process group on the CPU (with the package's own rank side,
``esr_tpu_torch/parallel/ranks.py``: building G and the GAN trainer's
steps). They import torch and the port only; the test modules compute the JAX side and pass weights and inputs in
as numpy arrays (state dicts bridged from JAX), and get numpy results back.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from esr_tpu_torch.models.architecture import RRDBNet
from esr_tpu_torch.parallel import comm
from esr_tpu_torch.parallel import tensor as ptensor
from esr_tpu_torch.parallel.ranks import _rows, build, gan_steps, t  # noqa: F401


def full_grads(g, grads: dict) -> dict:
    """Gradients by parameter name, a sharded trunk's gathered to full width."""
    names = ptensor.sharded_names(g)
    return {k: (comm.gather(v, g.tp_group, dim=1) if k in names else v).numpy() for k, v in grads.items()}


def grads_of(g, fn, lr, z, cot, sync=None) -> tuple[np.ndarray, dict]:
    """``fn(lr, z)`` and the gradients of mean(fn * cot) for G's parameters
    (reduced by ``sync``: a ``GradSync``) and for z."""
    z = z.clone().requires_grad_()
    out = fn(lr, z)
    names = [n for n, _ in g.named_parameters()]
    params = list(g.parameters())
    grads = torch.autograd.grad(torch.mean(out * cot), params + [z], allow_unused=True)
    gp = list(grads[:-1])
    if sync is not None:
        gp = sync(params, gp)
    gp = [torch.zeros_like(p) if v is None else v for p, v in zip(params, gp)]
    res = full_grads(g, dict(zip(names, gp)))
    res["Z"] = grads[-1].numpy()
    return out.detach().numpy(), res


def errors(fn, cases: list) -> list[str]:
    """The message each case raises (or 'no error')."""
    out = []
    for args in cases:
        try:
            fn(*args)
            out.append("no error")
        except ValueError as e:
            out.append(str(e))
    return out


def functions_2(p: dict) -> dict:
    """The parallel functions over 2 ranks."""
    from esr_tpu_torch.parallel import (
        make_mesh,
        make_spatial_tp_mesh,
        make_stage_mesh,
        make_tp_mesh,
        pipelined_rrdb_apply,
        spatial_sharded_forward,
        spatial_tp_apply,
        spatial_window_forward,
        tp_rrdb_apply,
    )
    from esr_tpu_torch.parallel.dp import GradSync

    res = {}
    smesh = make_mesh(2, spatial=2)
    spatial = smesh.group("spatial")
    # the ring variant, with and without Z
    g = build(*p["ring"]["model"])
    fwd = spatial_sharded_forward(g, smesh, scale=4, halo=8)
    res["ring"] = fwd(t(p["ring"]["lr"])).detach().numpy()
    res["ring_z"] = fwd(t(p["ring"]["lr"]), t(p["ring"]["z"])).detach().numpy()
    # exact-edge windows: forward, and gradients summed over the spatial axis
    g = build(*p["window"]["model"])
    fwd = spatial_window_forward(g, smesh, scale=4, halo=8)
    res["window"] = fwd(t(p["window"]["lr"]), t(p["window"]["z"])).detach().numpy()
    g = build(*p["window_grad"]["model"])
    fwd = spatial_window_forward(g, smesh, scale=4, halo=20)
    q = p["window_grad"]
    res["window_grad"] = grads_of(g, fwd, t(q["lr"]), t(q["z"]), t(q["tgt"]), GradSync([(spatial, "sum")]))
    # channel TP: forward, z=None, gradients; all_layers
    q = p["tp"]
    g = build(*q["model"])
    fn = tp_rrdb_apply(g, make_tp_mesh(2))
    res["tp"] = grads_of(g, fn, t(q["lr"]), t(q["z"]), t(q["tgt"]))
    with torch.no_grad():
        res["tp_none"] = fn(t(q["lr"])).numpy()
    res["tp_bytes"] = sum(v.numel() * v.element_size() for k, v in g.named_parameters() if k.startswith("RRDB"))
    g = build(*q["model_al"])
    with torch.no_grad():
        res["tp_al"] = tp_rrdb_apply(g, make_tp_mesh(2))(t(q["lr"]), t(q["z_al"])).numpy()
    # GPipe: forward, z=None, gradients (the stage's blocks summed over the axis); all_layers
    q = p["pp"]
    g = build(*q["model"])
    mesh = make_stage_mesh(2)
    fn = pipelined_rrdb_apply(g, mesh, n_micro=4)
    names = [n for n, _ in g.named_parameters()]
    owned = [n.startswith("RRDB_trunk.") for n in names]
    sync = GradSync([(mesh.group("stage"), lambda i: "sum" if owned[i] else "mean")])
    res["pp"] = grads_of(g, fn, t(q["lr"]), t(q["z"]), t(q["tgt"]), sync)
    with torch.no_grad():
        res["pp_none"] = fn(t(q["lr"])).numpy()
    g = build(*q["model_al"])
    with torch.no_grad():
        res["pp_al"] = pipelined_rrdb_apply(g, mesh, n_micro=4)(t(q["lr"]), t(q["z_al"])).numpy()
    # one spatial shard (the whole image) x 2-way TP
    q = p["single"]
    g = build(*q["model"])
    with torch.no_grad():
        res["single_tp"] = spatial_tp_apply(g, make_spatial_tp_mesh(1, 2), halo=2)(t(q["lr"]), t(q["z"])).numpy()
    # validation
    g = build(*p["ring"]["model"])
    ring = spatial_sharded_forward(g, smesh, scale=4, halo=8)
    window = spatial_window_forward(g, smesh, scale=4, halo=8)
    res["errors"] = errors(lambda f, x: f(x), [
        (ring, torch.zeros(1, 31, 8, 3)),  # 31 % 2
        (ring, torch.zeros(1, 8, 8, 3)),  # strip 4 < halo 8
        (window, torch.zeros(1, 24, 8, 3)),  # 2*halo 16 > strip 12
        (spatial_sharded_forward(g, smesh, halo=0), torch.zeros(1, 32, 8, 3)),
    ]) + errors(lambda f: f(), [
        (lambda: tp_rrdb_apply(RRDBNet(nf=8, nb=1, gc=3), make_tp_mesh(2)),),
        (lambda: pipelined_rrdb_apply(RRDBNet(nf=8, nb=3, gc=4), mesh, n_micro=2),),
        (lambda: spatial_tp_apply(RRDBNet(nf=8, nb=1, gc=3), make_spatial_tp_mesh(1, 2)),),
        (lambda: make_tp_mesh(2, data=2),),
        (lambda: make_stage_mesh(3),),
        (lambda: make_spatial_tp_mesh(2, 2),),
    ])
    return res


def functions_4(p: dict) -> dict:
    """The two-axis compositions over 4 ranks."""
    from esr_tpu_torch.parallel import make_mesh, make_spatial_tp_mesh, make_tp_mesh, spatial_tp_apply
    from esr_tpu_torch.parallel import spatial_window_forward, tp_rrdb_apply
    from esr_tpu_torch.parallel.dp import GradSync

    res = {}
    q = p["window_grad"]
    g = build(*q["model"])
    mesh = make_mesh(4, data=2, spatial=2)
    fwd = spatial_window_forward(g, mesh, scale=4, halo=20, data_axis="data")
    sync = GradSync([(mesh.group("data"), "sum"), (mesh.group("spatial"), "sum")])
    res["window_grad"] = grads_of(g, fwd, t(q["lr"]), t(q["z"]), t(q["tgt"]), sync)
    q = p["spatial_tp"]
    g = build(*q["model"])
    mesh = make_spatial_tp_mesh(2, 2)
    fwd = spatial_tp_apply(g, mesh, halo=8)
    with torch.no_grad():
        res["spatial_tp"] = fwd(t(q["lr"]), t(q["z"])).numpy()
        res["spatial_tp_none"] = fwd(t(q["lr"])).numpy()
    # the norm Adam's clip reads, under the trainer's spatial x TP reductions, of the trunk's gradients
    # (its sharded weights and replicated biases: the layers around it would swamp the shards' share)
    names, params = zip(*((n, v) for n, v in g.named_parameters() if n.startswith("RRDB_trunk.")))
    sharded = set(ptensor.sharded_names(g))
    sync = GradSync([(mesh.group("spatial"), "sum"),
                     (mesh.group("model"), lambda i: None if names[i] in sharded else "mean")])
    params = list(params)
    loss = torch.mean(fwd(t(q["lr"]), t(q["z"])) ** 2)
    grads = sync(params, list(torch.autograd.grad(loss, params, allow_unused=True)))
    full = full_grads(g, dict(zip(names, grads)))
    res["clip_norm"] = {"sq_sum": float(torch.sqrt(sync.sq_sum(grads))),
                        "full": float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in full.values()))),
                        "local": float(torch.sqrt(sum(torch.sum(v ** 2) for v in grads)))}
    q = p["tp_dp"]
    g = build(*q["model"])
    mesh = make_tp_mesh(2, data=2)
    fn = tp_rrdb_apply(g, mesh)
    data = mesh.group("data")
    n = q["lr"].shape[0] // data.size
    with torch.no_grad():
        rows = fn(t(q["lr"][data.index * n : (data.index + 1) * n]), t(q["z"][data.index * n : (data.index + 1) * n]))
        res["tp_dp"] = torch.cat(comm.gather_list(rows, data)).numpy()
    return res


def sr_steps(opt: dict, state: dict, hr: np.ndarray, steps: int) -> dict:
    """``steps`` SR-trainer steps of the trainer ``opt`` builds, through its
    own pipeline (the draws are the global batch's), each rank fed its rows
    of the global HR batch as its loader would."""
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    model = create_model(parse(opt, is_train=True), device="cpu")
    model._load_state(model.g_module, {k: t(v) for k, v in state.items()})
    metrics = []
    for s in range(1, steps + 1):
        model.feed_data({"HR": _rows(hr, model.data_shard())})
        model.optimize_parameters(s)
        metrics.append(model.get_current_losses())
    return {"metrics": metrics, "G": {k: v.numpy() for k, v in model._full_state(model.g_module).items()}}


def evaluate(opt: dict, variants: list[dict]) -> list[dict]:
    """The eval metrics of each variant of ``opt`` (a fresh model each: a
    sharded forward shards the generator in place); ``{}`` on ranks but 0."""
    from esr_tpu_torch.data import create_dataloader, create_dataset
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse
    from esr_tpu_torch.test import evaluate_dataset

    out = []
    for extra in variants:
        o = parse(dict(opt, **extra), is_train=False)
        model = create_model(o, device="cpu")
        d = o["datasets"]["test_1"]
        out.append(evaluate_dataset(model, create_dataloader(create_dataset(d), d), o))
    return out


def training_and_eval_2(p: dict) -> dict:
    """Every trainer and evaluator case of tests/test_torch_parallel_train.py, on 2 ranks."""
    res = {}
    for name, extra in p["gan_modes"].items():
        res[f"gan_{name}"] = gan_steps(dict(p["gan_opt"], **extra), p["gan_states"], p["gan_batch"], p["gan_eps"],
                                       p["gan_steps"])
    for name, (opt, state, hr) in p["sr"].items():
        res[f"sr_{name}"] = sr_steps(opt, state, hr, 2)
    res["eval"] = evaluate(p["eval_opt"], p["eval_variants"])
    return res


def dp_sgd_step(state: dict, lr: np.ndarray, hr: np.ndarray) -> dict:
    """One data-parallel SGD step (lr 1e-2, mean |G(LR) - HR|) of a tiny RRDB
    (nf 4, nb 1, gc 2) from ``state`` on the global batch: the loss and the
    parameters after it."""
    from esr_tpu_torch.parallel import make_dp_train_step, make_mesh

    g = build(dict(nf=4, nb=1, gc=2, scale=4), state)
    params = list(g.parameters())

    @torch.no_grad()
    def sgd(grads):
        torch._foreach_add_(params, grads, alpha=-1e-2)

    step = make_dp_train_step(lambda b, bc: bc.mean(torch.abs(g(b["LR"]) - b["HR"])), params, sgd, make_mesh())
    loss = step({"LR": t(lr), "HR": t(hr)})
    return {"loss": float(loss), "state": {k: v.numpy() for k, v in g.state_dict().items()}}


@torch.no_grad()
def cuda_axes_2(p: dict) -> dict:
    """The sharded eval forwards on the card (each rank on the one GPU, gloo),
    bf16 kernels, with the launches of each rank."""
    from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv
    from esr_tpu_torch.parallel import make_mesh, make_stage_mesh, make_tp_mesh
    from esr_tpu_torch.parallel import pipelined_rrdb_apply, spatial_window_forward, tp_rrdb_apply

    dev = comm.rank_device("cuda")
    counters = (rdb_conv.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP)
    res = {}
    for name in ("spatial", "tp", "pp"):
        g = build(dict(p["cfg"], dtype=torch.bfloat16), p["state"]).to(dev)
        if name == "spatial":
            fn = spatial_window_forward(g, make_mesh(2, spatial=2), scale=4, halo=p["halo"])
        elif name == "tp":
            fn = tp_rrdb_apply(g, make_tp_mesh(2))
        else:
            fn = pipelined_rrdb_apply(g, make_stage_mesh(2), n_micro=2)
        g.prepare_kernels()
        rows = set()
        hook = g.conv_first.register_forward_pre_hook(lambda m, a: rows.add(a[0].shape[1]))
        for c in counters:
            c.reset()
        out = fn(t(p["lr"]).to(dev), t(p["z"]).to(dev))
        torch.cuda.synchronize()
        hook.remove()
        res[name] = {"out": out.float().cpu().numpy(), "counts": {c.name: c.count for c in counters},
                     "rows": sorted(rows)}
    return res


def preempt_runs(runs: list) -> list[list[int]]:
    """``esr_tpu_torch.train._train`` on this rank for each ``(opt,
    auto_resume, raise_at)`` of ``runs`` in turn, on the CPU. ``raise_at[rank]``
    says when this rank's preemption flag goes up, as SIGTERM's handler raises
    it: ``("step", n)`` when step ``n`` ends; ``("check", n)`` from a thread
    while the ``n``-th stop check waits in its all-reduce (the flag already
    read; the other ranks enter that check late, so the wait is real); None,
    never. Returns the steps each run ran."""
    from esr_tpu_torch import train as train_cli
    from esr_tpu_torch.models.sr_model import SRModel
    from esr_tpu_torch.options import parse

    rank = comm.world()[0]
    optimize, any_rank = SRModel.optimize_parameters, getattr(comm, "any_rank", None)
    out = []
    for opt, auto_resume, raise_at in runs:
        ran, preempted, checks = [], {"flag": False}, []
        when, n = (raise_at[rank] if raise_at else None) or (None, None)
        at = next((r[1] for r in raise_at or () if r and r[0] == "check"), None)

        def step(self, s, ran=ran, preempted=preempted, when=when, n=n):
            optimize(self, s)
            ran.append(s)
            if when == "step" and s == n:
                preempted["flag"] = True

        def check(flag, checks=checks, preempted=preempted, when=when, at=at):
            checks.append(flag)
            if len(checks) != at:
                return any_rank(flag)
            if when != "check":
                time.sleep(0.5)  # the raising rank waits in the all-reduce meanwhile
                return any_rank(flag)
            raiser = threading.Timer(0.2, preempted.__setitem__, args=("flag", True))
            raiser.start()
            try:
                return any_rank(flag)
            finally:
                raiser.join()

        SRModel.optimize_parameters = step
        if at is not None:
            comm.any_rank = check
        try:
            train_cli._train(parse(opt, is_train=True), auto_resume, torch.device("cpu"), preempted)
        finally:
            SRModel.optimize_parameters = optimize
            if at is not None:
                comm.any_rank = any_rank
        torch.distributed.barrier()  # rank 0 writes the checkpoints the next run reads
        out.append(ran)
    return out



def any_rank_host_group() -> list:
    """``comm.any_rank`` as under an NCCL world (the default group's backend
    reported as ``nccl``): rank 1's flag, then no flag, over the gloo group
    it makes at its first call and keeps. Returns the two answers and whether
    the second call reused the first call's group."""
    real = comm.dist.get_backend
    comm.dist.get_backend = lambda group=None: "nccl" if group is None else real(group)
    try:
        first = comm.any_rank(comm.world()[0] == 1)
        pg = comm._HOST_GROUP[1]
        second = comm.any_rank(False)
        return [first, second, pg is not None and comm._HOST_GROUP[1] is pg]
    finally:
        comm.dist.get_backend = real
