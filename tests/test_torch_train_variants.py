"""Variants of the port's train steps against the JAX package's, on the CPU
(the set-up and tolerances of tests/test_torch_train.py): the G update gate
(``D_init_iters``, ``D_update_ratio``), the ``gan_weight: 0`` ablation, the
standard (non-relativistic) GAN, WGAN-GP (the penalty's interpolation
weights drawn as JAX draws them and handed to the port), global-norm
clipping, and the SR (PSNR) trainer's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.models.base_model import TrainState, make_adam, multistep_schedule
from esr_tpu.models.base_model import step_keyed as jstep_keyed
from esr_tpu.models.sr_model import make_sr_train_step as jmake_sr_train_step
from esr_tpu_torch.models import create_model, state_dict_from_jax
from esr_tpu_torch.models.base_model import step_keyed
from esr_tpu_torch.models.sr_model import make_sr_train_step
from esr_tpu_torch.options import parse

from test_torch_train_helpers import (
    JaxNets,
    RecordingAdam,
    check_gan_params,
    check_metrics,
    check_param_change,
    deep,
    fixed_batch,
    gan_opt,
    rel_l2,
    run_gan,
)

torch.set_num_threads(1)


def test_gan_gate_d_init_iters_and_ratio(tmp_path):
    """``D_init_iters: 1``, ``D_update_ratio: 2``: G updates at step 2 only of
    steps 1-3 (strict >, 1-based), Adam's count advances only then, D at
    every step; metrics and parameters as JAX's."""
    opt = gan_opt(str(tmp_path), D_init_iters=1, D_update_ratio=2, lr_steps=[3])
    run = run_gan(opt, 3, fixed_batch(1))
    check_metrics(run["jmetrics"], run["pmetrics"])
    check_gan_params(run, 3)
    assert run["g_opt"].count == 1 and run["d_opt"].count == 3
    assert len(run["g_opt"].grads) == 1
    # the JAX G is its init after step 1, and unchanged by step 3
    g0, g1, g2, g3 = (jax.tree.leaves(jax.device_get(run["states"][i][0].params)) for i in range(4))
    assert all(np.array_equal(a, b) for a, b in zip(g0, g1))
    assert all(np.array_equal(a, b) for a, b in zip(g2, g3))
    assert not all(np.array_equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("variant", ["gan_weight_0", "standard_gan", "wgan_gp", "grad_clip"])
def test_gan_step_variants_match_jax(tmp_path, variant):
    """Two steps of each variant: every metric and G's and D's parameters."""
    extra = {"gan_weight_0": {"gan_weight": 0}, "standard_gan": {"relativistic": False},
             "wgan_gp": {"gan_type": "wgan-gp"}, "grad_clip": {"grad_clip": 0.05}}[variant]
    run = run_gan(gan_opt(str(tmp_path), **extra), 2, fixed_batch(2))
    check_metrics(run["jmetrics"], run["pmetrics"])
    check_gan_params(run, 2)
    if variant == "gan_weight_0":
        assert all(m["l_g_gan"] == 0.0 for m in run["pmetrics"])
    if variant == "grad_clip":  # the clip bound: the gradients' global norm is above it
        norm = float(torch.sqrt(sum(g.pow(2).sum() for g in run["g_opt"].grads[0])))
        assert norm > 0.05


def test_sr_step_matches_jax(tmp_path):
    """The SR trainer's step (l1 pixel loss of the raw G, no CEM, step-keyed
    MultiStepLR with a milestone at 2): metrics, the step-1 gradients, and
    G after 3 steps."""
    opt = gan_opt(str(tmp_path), lr_G=2e-4, lr_steps=[2], pixel_weight=1.0)
    opt["model"] = "sr"
    cfg = opt["train"]
    nets = JaxNets(opt)
    batch = fixed_batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    sched = multistep_schedule(cfg["lr_G"], cfg["lr_steps"], cfg["lr_gamma"])
    state = TrainState.create(apply_fn=nets.g.apply, params=nets.g_params, tx=make_adam(jstep_keyed(sched)))
    jstep = jax.jit(jmake_sr_train_step(nets.g, lambda h, r: jb, "l1", 1.0))
    g_grad = jax.grad(lambda p: jnp.mean(jnp.abs(nets.g.apply({"params": p}, jb["LR"], jb["Z"]) - jb["HR"])))(
        nets.g_params)
    jmetrics = []
    for s in range(1, 4):
        state, m = jstep(state, jnp.zeros(()), jax.random.PRNGKey(s))
        jmetrics.append({k: float(v) for k, v in jax.device_get(m).items()})

    model = create_model(parse(deep(opt), is_train=True), device="cpu")
    nets.load_port(model)
    g_opt = RecordingAdam(model.g_opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pstep = make_sr_train_step(model.g_module, lambda h, g: tb, g_opt, step_keyed(model.schedulers["G"]))
    pmetrics = [{k: float(v) for k, v in pstep(None, torch.Generator()).items()} for _ in range(3)]
    check_metrics(jmetrics, pmetrics)
    want = state_dict_from_jax(jax.device_get(g_grad))
    for (name, _), g in zip(model.g_module.named_parameters(), g_opt.grads[0]):
        assert rel_l2(g.numpy(), want[name]) <= 1e-3, name
    check_param_change(state_dict_from_jax(jax.device_get(nets.g_params)),
                       state_dict_from_jax(jax.device_get(state.params)), model.g_module.state_dict(),
                       cfg["lr_G"], 3)
    assert g_opt.count == 3
