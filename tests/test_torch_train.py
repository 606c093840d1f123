"""The port's GAN train step against ``esr_tpu.models.srragan_model.
make_gan_train_step``, on the CPU, f32, at the tiny size of
``test_torch_train_helpers`` (nf 8, nb 1, gc 4, HR 32, one Z channel, CEM, D with
BatchNorm, VGG19 to conv5_4): the same weights (JAX init, carried by the
bridges) and one fixed batch, injected as the ``pipeline`` of both steps.

Tolerances, and why:
- the metrics of the first step within 1e-4 relative (f32 sums in another
  order); of steps 2-3 within 1e-3 (see the next point);
- G's and D's gradients of the first step within 1e-3 relative L2 per
  tensor, against JAX gradients taken from ``g_module.apply`` +
  ``cem.project`` + the losses composed as the step's ``g_loss_fn``. Three
  gradients are zero in exact arithmetic and float noise in both
  frameworks: conv_last's bias (the CEM projection removes a constant
  shift of a channel), D's ``linear2`` bias and the ``linear1`` bias of
  units whose LeakyReLU side is the same for the whole batch (the
  relativistic loss does not change when every logit shifts by one
  constant). Those are held to an absolute bound of 1e-6 of the largest
  gradient of their network;
- D's running statistics after the first step within 1e-5 relative (the
  biased variance, as flax updates it);
- parameters after 3 steps: Adam divides each gradient element by its own
  magnitude, so an element whose gradient is float noise (the zero
  gradients above, or a rare element of a weight that cancels to noise)
  steps by up to the learning rate in either framework, and an absolute
  1e-5 bound on every element does not hold (up to 5e-5 seen). So every
  element within Adam's bound (one learning rate per step), and all but one
  element in a thousand (at least one per tensor) within 1e-5
  (``test_torch_train_helpers.check_param_change``); the step-1 gradients above
  pin the arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu_torch.models import discriminator_state_dict_from_jax, state_dict_from_jax

from test_torch_train_helpers import (
    NOISE_GRADS,
    check_gan_params,
    check_metrics,
    d_loss_jax,
    d_state_dict,
    fixed_batch,
    g_loss_jax,
    gan_opt,
    rel_l2,
    run_gan,
)

torch.set_num_threads(1)

STEPS = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Three steps of both trainers on the same weights and batch (the
    learning-rate milestone at step 2 crossed), plus JAX's step-1 gradients
    by composition; the port's are what its recording Adam received."""
    opt = gan_opt(str(tmp_path_factory.mktemp("gan")))
    cfg, batch = opt["train"], fixed_batch()
    out = run_gan(opt, STEPS, batch)
    nets = out["nets"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g_grads = jax.grad(lambda p: g_loss_jax(nets, cfg, p, nets.d_vars, jb)[0])(nets.g_params)
    hr_proj = nets.cem.enforce_dt_on_image_pair(jb["LR"], jb["HR"])
    fake = jax.lax.stop_gradient(g_loss_jax(nets, cfg, nets.g_params, nets.d_vars, jb)[1])
    d_grads = jax.grad(lambda p: d_loss_jax(nets, cfg, p, nets.d_vars, hr_proj, fake))(nets.d_vars["params"])
    out["g_grads"] = state_dict_from_jax(jax.device_get(g_grads))
    out["d_grads"] = discriminator_state_dict_from_jax({"params": jax.device_get(d_grads)})
    return out


def test_gan_step_metrics_match_jax(run):
    """Every metric of each step: the same keys in the same order, values
    within 1e-4 relative at step 1 and 1e-3 at steps 2-3."""
    for pm in run["pmetrics"]:
        assert list(pm) == ["l_d", "l_g", "D_real", "D_fake", "l_g_pix", "l_g_fea", "l_g_gan", "l_g_range",
                            "l_g_map", "psnr"]
    check_metrics(run["jmetrics"], run["pmetrics"])


def _check_grads(names, port, ref):
    largest = max(float(np.abs(np.asarray(ref[n])).max()) for n in names)
    for n, g in zip(names, port):
        want = np.asarray(ref[n])
        if n in NOISE_GRADS:
            assert float(np.abs(g.numpy() - want).max()) <= max(1e-6 * largest, 1e-3 * np.abs(want).max()), n
        else:
            assert rel_l2(g.numpy(), want) <= 1e-3, (n, rel_l2(g.numpy(), want))


def test_gan_step_gradients_match_jax(run):
    """G's and D's gradients of step 1 (the ones each Adam received) against
    JAX's composed ``g_loss_fn`` / ``d_loss_fn``."""
    model = run["model"]
    g_names = [n for n, _ in model.g_module.named_parameters()]
    d_names = [n for n, _ in model.d_module.named_parameters()]
    assert len(run["g_opt"].grads) == STEPS and len(run["d_opt"].grads) == STEPS
    _check_grads(g_names, run["g_opt"].grads[0], run["g_grads"])
    _check_grads(d_names, run["d_opt"].grads[0], run["d_grads"])
    # the zero-in-exact-arithmetic gradients are float noise on both sides
    assert float(np.abs(run["g_grads"]["conv_last.bias"]).max()) < 1e-6


def test_gan_batch_stats_after_one_step_match_jax(run):
    """D's running mean and (biased-variance) running var after step 1 and 3."""
    for i in (0, STEPS - 1):
        want = d_state_dict(run["states"][i + 1][1])
        for k, v in run["pstats"][i].items():
            assert rel_l2(v.numpy(), want[k]) <= 1e-5, (i + 1, k)
    # one step moved them off their init (0 mean, 1 var)
    moved = run["pstats"][0]["bn0_1.running_mean"]
    assert float(moved.abs().max()) > 1e-4


def test_gan_params_after_three_steps_match_jax(run):
    """G and D after 3 steps against JAX (``check_param_change``); the
    learning-rate milestone at step 2 is crossed on both sides."""
    check_gan_params(run, STEPS)
    assert run["g_opt"].count == STEPS and run["d_opt"].count == STEPS
