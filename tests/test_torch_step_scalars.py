"""Step scalars as device tensors, on the CPU: what a CUDA graph of a train
step or a Z step reads at each replay instead of Python floats frozen at
capture.

- ``Adam`` reads its learning rate and bias corrections from its
  ``scalars`` tensor: over 50 steps, with and without ``grad_clip``, its
  moments equal the host-scalar formula's (``_host_adam_step``, the form it
  replaced) bit for bit, and so do the parameters where the learning rate is
  a power of two (the product ``lr * update`` is exact). At another learning
  rate the parameters are within 1 ulp per element of that formula applied
  to the same state (the ulp of the larger of the result and ``lr * u``):
  the host form fused ``p - lr * u`` into one rounding (``alpha=-lr``), the
  device form rounds ``lr * u`` first;
- the three ways to stage the scalars (``step(grads, lr)``, ``stage``, a
  chunk's rows and a slot copy) give the same update;
- the Z searches are unchanged: ``optimize_z`` and ``optimize_z_adaptive``
  against the JAX package's through a small generator (nf 8, nb 1, gc 4,
  LR 8 -> HR 32, CEM, f32), with a :class:`ZSearchCache` that serves a
  second click of the same objective and crop from the first click's
  buffers, equal to a search on fresh buffers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.cem import CEMConf as JCEMConf
from esr_tpu.cem import make_cem as jmake_cem
from esr_tpu.explore import objectives as JO
from esr_tpu.explore import z_optimizer as JZ
from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.explore import objectives as PO
from esr_tpu_torch.explore import z_optimizer as PZ
from esr_tpu_torch.models import define_G, state_dict_from_jax
from esr_tpu_torch.models.base_model import Adam, multistep_schedule, step_keyed

from test_torch_explore_helpers import t, z_close

torch.set_num_threads(1)

SHAPES = [(3, 3, 8, 4), (4,), (17,), (2, 5)]


def _host_adam_step(params, mu, nu, count, grads, lr, b1=0.9, b2=0.999, eps=1e-8, grad_clip=None):
    """The update as it was written with host scalars (before the step
    scalars moved to the device), on copies; returns (params, mu, nu)."""
    params, mu, nu = ([x.clone() for x in xs] for xs in (params, mu, nu))
    if grad_clip:
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        scale = torch.where(norm < grad_clip, torch.ones_like(norm), grad_clip / norm)
        grads = [g * scale.to(g.dtype) for g in grads]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
    denom = torch._foreach_div(nu, 1 - b2**count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu, 1 - b1**count)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(params, upd, alpha=-lr)
    return params, mu, nu


def _grads(step: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(step)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * (1 + step % 3)) for s in SHAPES]


def _ulps(a: torch.Tensor, b: torch.Tensor, step: torch.Tensor) -> float:
    """|a - b| in units in the last place of the larger of |b| and |step|
    (the subtraction's operand ``lr * u``: where it cancels most of the
    parameter, the result is smaller than the operand, and so is its ulp),
    at most over the elements."""
    spacing = torch.from_numpy(np.spacing(np.maximum(np.abs(b.numpy()), np.abs(step.numpy()))))
    return float(((a - b).abs() / spacing).max())


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("lr_kind", ["power_of_two", "schedule"])
def test_adam_device_scalars_match_host_formula(clip, lr_kind):
    """50 steps: moments bit for bit against the host formula's own run;
    parameters bit for bit at lr 2^-10, else within 1 ulp of the host
    formula applied to the same state at each step."""
    rng = np.random.default_rng(7)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in SHAPES]
    sched = (lambda c: 2.0**-10) if lr_kind == "power_of_two" else step_keyed(multistep_schedule(3e-4, [20, 40], 0.5))
    opt = Adam([p.clone() for p in params], grad_clip=clip)
    host = [p.clone() for p in params], [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    worst = 0.0
    for step in range(50):
        grads, lr = _grads(step), sched(opt.count)
        before = [p.clone() for p in opt.params]
        same_state = _host_adam_step(opt.params, opt.mu, opt.nu, step + 1, grads, lr, grad_clip=clip)
        host = _host_adam_step(*host, step + 1, grads, lr, grad_clip=clip)
        opt.step(grads, lr)
        assert opt.count == step + 1
        for got, want in zip(opt.mu + opt.nu, host[1] + host[2]):
            assert torch.equal(got, want)
        if lr_kind == "power_of_two":
            assert all(torch.equal(a, b) for a, b in zip(opt.params, host[0]))
        lr_u = [b - a for a, b in zip(same_state[0], before)]
        worst = max([worst] + [_ulps(a, b, d) for a, b, d in zip(opt.params, same_state[0], lr_u)])
    assert worst <= 1.0


def test_adam_staging_routes_agree():
    """``step(g, lr)``; ``stage(lr)`` then ``step(g)``; a chunk's rows
    (``next_scalars`` for every step, one ``scalar_rows`` upload, a slot copy
    before each ``step(g)``): the same parameters, moments and count."""
    rng = np.random.default_rng(3)
    p0 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in SHAPES]
    sched = step_keyed(multistep_schedule(1e-3, [2], 0.5))
    opts = [Adam([p.clone() for p in p0], grad_clip=1.0) for _ in range(3)]
    for step in range(4):
        opts[0].step(_grads(step), sched(opts[0].count))
        opts[1].stage(sched(opts[1].count))
        opts[1].step(_grads(step))
    table = opts[2].scalar_rows([opts[2].next_scalars(sched(opts[2].count)) for _ in range(4)])
    assert table.shape == (4, 3) and table.dtype == torch.float32
    for step in range(4):
        opts[2].scalars.copy_(table[step])
        opts[2].step(_grads(step))
    for o in opts[1:]:
        assert o.count == opts[0].count == 4
        for a, b in zip(o.params + o.mu + o.nu, opts[0].params + opts[0].mu + opts[0].nu):
            assert torch.equal(a, b)
    # the scalars of the last step: float64 on the host, then f32
    assert torch.equal(opts[0].scalars, torch.tensor([5e-4, 1 - 0.9**4, 1 - 0.999**4], dtype=torch.float64).float())


# -- the Z searches ----------------------------------------------------------------------


LR = 8


class Small:
    """The explorer's generator at nf 8, nb 1, gc 4 on both sides, JAX's init."""

    def __init__(self):
        model = JRRDBNet(nf=8, nb=1, gc=4, scale=4, num_latent_channels=1)
        self.lr = np.random.default_rng(0).random((1, LR, LR, 3)).astype(np.float32)
        variables = model.init(jax.random.PRNGKey(0), jnp.asarray(self.lr), jnp.zeros((1, LR, LR, 1)))
        self.params = variables["params"]
        jcem = jmake_cem(JCEMConf(scale=4))
        self.jforward = lambda p, lr, z: jcem.project(model.apply({"params": p}, lr, z), lr)
        g = define_G({"network_G": {"nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1}, "scale": 4,
                      "bf16": False}, device="cpu")
        g.load_state_dict(state_dict_from_jax(variables), strict=True)
        g.requires_grad_(False)
        cem = make_cem(CEMConf(scale=4), device="cpu")
        self.forward = lambda lr, z: cem.project(g(lr, z), lr)


@pytest.fixture(scope="module")
def small():
    return Small()


def _z0(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (1, LR, LR, 1)).astype(np.float32)


def _mask() -> np.ndarray:
    m = np.zeros((LR * 4, LR * 4), np.float32)
    m[4:24, 6:30] = 1.0
    return m


def _jax_grad0(small, objective, z0, mask):
    fn, aux = objective.fn, objective.aux or {}
    return jax.grad(lambda z: fn(small.jforward(small.params, jnp.asarray(small.lr), z), jnp.asarray(mask), aux))(
        jnp.asarray(z0))


def test_optimize_z_cached_clicks_match_jax(small):
    """Two clicks of the variance tool (two starting Z) through one cache:
    the second reuses the first's buffers (reset: Z, Adam's moments and
    count), each equals JAX's search and a search on fresh buffers."""
    cache, mask, kw = PZ.ZSearchCache(), _mask(), dict(n_steps=6, lr=0.1, z_range=1.0, lr_decay=0.5)
    searches = []
    for seed in (1, 2):
        z0 = _z0(seed)
        jz, jl = JZ.optimize_z(small.jforward, small.params, jnp.asarray(small.lr), jnp.asarray(z0),
                               jnp.asarray(mask), JO.variance_objective(1.0), **kw)
        pz, pl = PZ.optimize_z(small.forward, t(small.lr), t(z0), t(mask), PO.variance_objective(1.0), cache=cache,
                               **kw)
        fz, fl = PZ.optimize_z(small.forward, t(small.lr), t(z0), t(mask), PO.variance_objective(1.0), **kw)
        assert torch.equal(pz, fz) and np.array_equal(pl, fl)
        np.testing.assert_allclose(pl, np.asarray(jl), rtol=1e-4)
        z_close(pz.numpy(), jz, _jax_grad0(small, JO.variance_objective(1.0), z0, mask))
        searches.append(next(iter(cache._searches.values())))
    assert len(cache._searches) == 1 and searches[0] is searches[1]


def test_optimize_z_adaptive_cached_matches_jax(small):
    """The adaptive imprint search (rounds with the LR boosted) through a
    cache warm from another objective's search: rounds, trace and best Z as
    JAX's, and as a search on fresh buffers."""
    mask, z0 = _mask(), _z0(3)
    target = np.random.default_rng(4).random((LR * 4, LR * 4, 3)).astype(np.float32)
    kw = dict(n_steps=3, lr=0.05, z_range=1.0, max_rounds=3, lr_boost=3.0, lr_max=0.45, plateau_rel=0.5)
    cache = PZ.ZSearchCache()
    PZ.optimize_z(small.forward, t(small.lr), t(_z0(5)), t(mask), PO.tv_objective(), n_steps=2, cache=cache)
    jz, jl, jr = JZ.optimize_z_adaptive(small.jforward, small.params, jnp.asarray(small.lr), jnp.asarray(z0),
                                        jnp.asarray(mask), JO.imprint_objective(jnp.asarray(target)), **kw)
    pz, pl, pr = PZ.optimize_z_adaptive(small.forward, t(small.lr), t(z0), t(mask), PO.imprint_objective(target),
                                        cache=cache, **kw)
    fz, fl, fr = PZ.optimize_z_adaptive(small.forward, t(small.lr), t(z0), t(mask), PO.imprint_objective(target),
                                        **kw)
    assert torch.equal(pz, fz) and np.array_equal(pl, fl) and pr == fr
    assert len(pr) == len(jr) and pr[-1]["stop"] == jr[-1]["stop"]
    for a, b in zip(pr, jr):
        assert a["lr"] == pytest.approx(b["lr"]) and a["z_range"] == pytest.approx(b["z_range"])
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=1e-4, atol=1e-6)
    z_close(pz.numpy(), jz, _jax_grad0(small, JO.imprint_objective(jnp.asarray(target)), z0, mask))
    assert len(cache._searches) == 2
