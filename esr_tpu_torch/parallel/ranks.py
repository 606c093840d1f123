"""The rank side of the multi-process runs: functions that
``comm.spawn`` (or a launcher) runs on each rank of a process group, shared
by the dry run (``esr_tpu_torch.graft_entry.dryrun_multichip``) and the
parallel-axes tests. Weights and inputs come in as numpy arrays (state dicts
with the reference keys) and results go back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from esr_tpu_torch.models.architecture import RRDBNet
from esr_tpu_torch.parallel import tensor as ptensor

__all__ = ["build", "gan_steps", "t"]


def build(cfg: dict, state: dict) -> RRDBNet:
    g = RRDBNet(**cfg)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return g


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _rows(x, shard):
    i, n = shard
    k = x.shape[0] // n
    return x[i * k : (i + 1) * k]


def _recording(opt_):
    """Keep the gradients ``opt_.step`` is given (after the ranks' reduction)
    and the global norm its clip reads from them."""
    seen, norms = [], []
    step = opt_.step

    def record(grads, lr, sq_sum=None):
        seen.append([g.detach().clone() for g in grads])
        sq = sq_sum(grads) if sq_sum is not None else sum(torch.sum(g.float() ** 2) for g in grads)
        norms.append(float(torch.sqrt(sq)))
        step(grads, lr, sq_sum)

    opt_.step = record
    return seen, norms


def gan_steps(opt: dict, states: dict | None, batch: dict, eps: list, steps: int) -> dict:
    """``steps`` GAN steps, on the CPU, of the trainer that ``opt``'s parallel
    options build, from the given weights (G, D and VGG19 state dicts; the
    seeded ones when None), each rank on its rows of the fixed batch (the
    draws of the WGAN-GP weights handed in, as the global batch's)."""
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.models.base_model import step_keyed
    from esr_tpu_torch.models.srragan_model import make_gan_train_step
    from esr_tpu_torch.options import parse

    model = create_model(parse(opt, is_train=True), device="cpu")
    if states is not None:
        model._load_state(model.g_module, {k: t(v) for k, v in states["G"].items()})
        model.d_module.load_state_dict({k: t(v) for k, v in states["D"].items()}, strict=True)
        model.f_module.load_torchvision({k: t(v) for k, v in states["F"].items()})
    par = model._par
    tb = {k: t(v) for k, v in batch.items()}
    seen, norms = _recording(model.g_opt)
    step = make_gan_train_step(model.g_module, model.d_module, model.f_module, model.cem,
                               lambda h, gen, shard=(0, 1): {k: _rows(v, shard) for k, v in tb.items()},
                               opt["train"], model.g_opt, model.d_opt, model.schedulers["G"],
                               step_keyed(model.schedulers["D"]), par=par)
    metrics = []
    for s in range(1, steps + 1):
        m = step(None, torch.Generator(), s, gp_eps=_rows(t(eps[s - 1]), par.shard))
        metrics.append({k: float(v) for k, v in m.items()})
    g_state = {k: v.numpy() for k, v in model._full_state(model.g_module).items()}
    names = [n for n, _ in model.g_module.named_parameters()]
    grads = dict(zip(names, (g.numpy() for g in ptensor.full_param_tensors(model.g_module, seen[0]))))
    local_trunk = sum(p.numel() for n, p in model.g_module.named_parameters() if n.startswith("RRDB"))
    moments = sum(m.numel() for n, m in zip(names, model.g_opt.mu) if n.startswith("RRDB"))
    return {"metrics": metrics, "G": g_state, "D": {k: v.numpy() for k, v in model.d_module.state_dict().items()},
            "grads": grads, "g_norms": norms, "shard": par.shard, "trunk_numel": local_trunk,
            "trunk_moments": moments}
