"""The parts of the port's training slice against the JAX package's, on the
CPU, f32, inputs from numpy seeds: every loss, the discriminator and the
VGG19 feature extractor (outputs, BatchNorm statistics, the weight bridges),
the schedules, Adam and its clipping, and the kernels' autograd Functions.

Tolerances: losses 1e-5 relative (f32 reductions in another order; the
gradient penalty 1e-4: a double backward); D and VGG outputs 1e-4 relative
to the output scale (up to 16 convs deep in f32); D's running statistics
1e-5 relative to their largest value; schedules exact; Adam and the clip 1e-6 relative over three
updates (the same f32 formula); the Functions' gradients by
``torch.autograd.gradcheck`` in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esr_tpu.models import losses as JL
from esr_tpu.models.base_model import make_adam as jmake_adam
from esr_tpu.models.base_model import multistep_schedule as jmultistep
from esr_tpu.models.base_model import step_keyed as jstep_keyed
from esr_tpu.models.networks import define_D as jdefine_D
from esr_tpu.models.networks import define_F as jdefine_F
from esr_tpu.models.networks import discriminator_to_torch, load_vgg19_from_torch
from esr_tpu_torch.models import (
    define_D,
    define_F,
    discriminator_state_dict_from_jax,
    losses as L,
    vgg_state_dict_from_jax,
)
from esr_tpu_torch.models.base_model import Adam, multistep_schedule, step_keyed
from esr_tpu_torch.ops.cuda import autograd as fns
from esr_tpu_torch.ops.cuda.kpack_conv import conv3x3_reference
from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_reference
from esr_tpu_torch.ops.fused import upsample2x_conv3x3_reference

torch.set_num_threads(1)


def _np(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, rtol):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-6), (got, want)


# -- losses --------------------------------------------------------------------


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan-gp"])
@pytest.mark.parametrize("relativistic", [True, False])
def test_gan_losses_match_jax(gan_type, relativistic):
    r, f = _np((4, 1), 0), _np((4, 1), 1)
    for real in (True, False):
        _close(L.gan_loss(torch.from_numpy(r), real, gan_type), JL.gan_loss(jnp.asarray(r), real, gan_type), 1e-5)
    for pf, jf in ((L.ragan_d_loss, JL.ragan_d_loss), (L.ragan_g_loss, JL.ragan_g_loss)):
        _close(pf(torch.from_numpy(r), torch.from_numpy(f), gan_type, relativistic),
               jf(jnp.asarray(r), jnp.asarray(f), gan_type, relativistic), 1e-5)


def test_gan_loss_refuses_unknown_type():
    with pytest.raises(ValueError, match="unknown gan_type"):
        L.gan_loss(torch.zeros(2, 1), True, "hinge")


@pytest.mark.parametrize("kind", ["l1", "l2", "cb"])
def test_pixel_loss_matches_jax(kind):
    a, b = _np((2, 8, 8, 3), 2), _np((2, 8, 8, 3), 3)
    _close(L.pixel_loss(torch.from_numpy(a), torch.from_numpy(b), kind),
           JL.pixel_loss(jnp.asarray(a), jnp.asarray(b), kind), 1e-5)


@pytest.mark.parametrize("name", ["range_loss", "tv_loss", "local_std", "perceptual_l1", "map_loss"])
def test_image_losses_match_jax(name):
    sr = _np((2, 16, 16, 3), 4, -0.2, 1.2)
    hr = _np((2, 16, 16, 3), 5, 0.0, 1.0)
    z = _np((2, 4, 4, 2), 6, -1.0, 1.0)
    t = torch.from_numpy
    if name == "local_std":
        got, want = L.local_std(t(sr), 5), JL.local_std(jnp.asarray(sr), 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
        return
    args = {"range_loss": (sr,), "tv_loss": (sr,), "perceptual_l1": (sr, hr), "map_loss": (sr, hr, z)}[name]
    _close(getattr(L, name)(*map(t, args)), getattr(JL, name)(*map(jnp.asarray, args)), 1e-5)


def test_gradient_penalty_matches_jax():
    """The WGAN-GP penalty of one small differentiable critic (a tanh of a
    fixed linear map, per sample) at the same interpolation weights."""
    real, fake = _np((3, 6, 6, 2), 7), _np((3, 6, 6, 2), 8)
    w = _np((6, 6, 2), 9)

    def jd(params, x):
        return jnp.tanh(jnp.sum(x**2 * params, axis=(1, 2, 3)))[:, None]

    key = jax.random.PRNGKey(3)
    want = JL.gradient_penalty(jd, jnp.asarray(w), jnp.asarray(real), jnp.asarray(fake), key)
    jeps = np.asarray(jax.random.uniform(key, (3, 1, 1, 1)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = L.gradient_penalty(lambda x: torch.tanh(torch.sum(x**2 * wt, dim=(1, 2, 3)))[:, None],
                             torch.from_numpy(real), torch.from_numpy(fake), torch.from_numpy(jeps))
    _close(got, want, 1e-4)
    # the penalty trains the critic: a double backward reaches its weights
    (gw,) = torch.autograd.grad(got, wt)
    jgw = jax.grad(lambda p: JL.gradient_penalty(jd, p, jnp.asarray(real), jnp.asarray(fake), key))(jnp.asarray(w))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-3, atol=1e-4 * float(np.abs(jgw).max()))


# -- discriminator and feature extractor ---------------------------------------


def _d_opt(hr, nf=8, norm="batch"):
    return {"bf16": False, "network_D": {"nf": nf, "norm_type": norm}, "datasets": {"train": {"HR_size": hr}}}


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_discriminator_matches_jax(norm):
    """D's logits in train mode (batch statistics) and eval mode, and the
    running statistics of one updating call (flax's biased variance,
    momentum 0.9 = torch 0.1), on the JAX init carried by the bridge."""
    opt = _d_opt(32, norm=norm)
    jd = jdefine_D(opt)
    x = _np((4, 32, 32, 3), 11, 0.0, 1.0)
    jvars = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    d = define_D(opt, device="cpu")
    d.load_state_dict(discriminator_state_dict_from_jax(jax.device_get(jvars), hr_size=32), strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        eval_out = d(xt, train=False)
        train_out = d(xt, train=True, update_stats=True)
    np.testing.assert_allclose(eval_out.numpy(), np.asarray(jd.apply(jvars, jnp.asarray(x), train=False)),
                               rtol=1e-4, atol=1e-4 * float(np.abs(eval_out.numpy()).max()))
    if norm == "none":
        np.testing.assert_allclose(train_out.numpy(), eval_out.numpy())
        return
    jout, mutated = jd.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(train_out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4 * scale)
    want = discriminator_state_dict_from_jax({**jax.device_get(jvars), **jax.device_get(mutated)}, hr_size=32)
    for k, v in d.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-5 * float(want[k].abs().max()), err_msg=k)
    # a call without update_stats leaves them as they are
    before = {k: v.clone() for k, v in d.state_dict().items()}
    with torch.no_grad():
        d(xt, train=True)
    assert all(torch.equal(before[k], v) for k, v in d.state_dict().items())


def test_discriminator_bridge_matches_discriminator_to_torch():
    """Key for key, value for value, the JAX package's torch converter at HR
    128 (its 4 x 4 final map), and the port's D takes it strictly."""
    opt = _d_opt(128)
    jvars = jdefine_D(opt).init(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 3)), train=False)
    ours = discriminator_state_dict_from_jax(jax.device_get(jvars))
    ref = discriminator_to_torch(jax.device_get(jvars))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    define_D(opt, device="cpu").load_state_dict(ours, strict=True)
    assert define_D(opt, device="cpu").linear1.in_features == 4 * 4 * 8 * 8


@pytest.mark.parametrize("layer", [34, 21])
def test_vgg_matches_jax_and_bridge_inverts_loader(layer):
    """VGG19 features (ImageNet input norm, up to the conv at ``layer`` before
    its ReLU: 34 conv5_4, 21 conv4_2) on the JAX init; ``vgg_state_dict_from_jax`` is the inverse of
    ``load_vgg19_from_torch``."""
    opt = {"bf16": False, "train": {"feature_layer": layer}}
    jf = jdefine_F(opt)
    x = _np((2, 32, 32, 3), 12, 0.0, 1.0)
    jvars = jax.device_get(jf.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3))))
    sd = vgg_state_dict_from_jax(jvars)
    back = load_vgg19_from_torch({k: v.numpy() for k, v in sd.items()}, feature_layer=layer)["params"]
    assert set(back) == set(jvars["params"])
    for name, conv in jvars["params"].items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(back[name][leaf]), np.asarray(conv[leaf]))
    f = define_F(opt, device="cpu")
    f.load_torchvision(dict(sd, **{"classifier.0.weight": torch.zeros(1)}))
    assert not any(p.requires_grad for p in f.parameters())
    with torch.no_grad():
        got = f(torch.from_numpy(x)).numpy()
    want = np.asarray(jf.apply(jvars, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    with pytest.raises(KeyError, match="lacks"):
        f.load_torchvision({})


# -- schedules, Adam, clipping -------------------------------------------------


def test_multistep_schedule_matches_optax_at_milestones():
    """lr(step) at milestone - 1, milestone and milestone + 1, for the
    schedule as G reads it (the global step) and step-keyed as D reads it."""
    steps = [5, 9]
    ours, ref = multistep_schedule(1e-4, steps, 0.5), jmultistep(1e-4, steps, 0.5)
    for s in (0, 1, 4, 5, 6, 8, 9, 10, 50):
        assert ours(s) == pytest.approx(float(ref(s)), rel=1e-7), s
        assert step_keyed(ours)(s) == pytest.approx(float(jstep_keyed(ref)(s)), rel=1e-7), s
    assert ours(4) == 1e-4 and ours(5) == 5e-5 and ours(9) == 2.5e-5
    assert multistep_schedule(2e-4, [])(10**6) == 2e-4


@pytest.mark.parametrize("clip", [None, 0.5, 100.0])
def test_adam_and_clip_match_optax(clip):
    """Three updates of the port's Adam against optax's adam (after
    clip_by_global_norm), learning rates read step-keyed."""
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [_np(s, 20 + i) for i, s in enumerate(shapes)]
    sched = multistep_schedule(1e-2, [2], 0.5)
    tx = jmake_adam(jstep_keyed(jmultistep(1e-2, [2], 0.5)), grad_clip=clip)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = Adam(tp, grad_clip=clip)
    for k in range(3):
        grads = [_np(s, 100 * k + i) * (1 + k) for i, s in enumerate(shapes)]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g) for g in grads], step_keyed(sched)(opt.count))
    assert opt.count == 3
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    # the state round-trips
    opt2 = Adam([p.clone() for p in tp], grad_clip=clip)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.count == 3 and all(torch.equal(a, b) for a, b in zip(opt2.mu, opt.mu))


def test_clip_is_optax_formula():
    """Below the bound the gradients pass unchanged; above it they are scaled
    to norm ``grad_clip`` exactly (no epsilon)."""
    g = [torch.full((4,), 3.0), torch.full((1,), 4.0)]
    opt = Adam([torch.zeros(4), torch.zeros(1)], grad_clip=1.0)
    clipped = opt.clip(g)
    norm = torch.sqrt(sum(t.pow(2).sum() for t in clipped))
    assert float(norm) == pytest.approx(1.0, abs=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(Adam(opt.params, grad_clip=1e3).clip(g), g))


# -- the kernels' autograd Functions -------------------------------------------


@pytest.fixture
def plain_launch(monkeypatch):
    """The Functions' kernel launches replaced by the plain versions (no CUDA
    here), so that their save / recompute plumbing can be checked."""
    monkeypatch.setattr(fns, "_rdb5c_live", rdb5c_reference)
    monkeypatch.setattr(fns, "_conv_live", lambda x, k, b, act, ksize: (
        conv3x3_reference if ksize == 3 else upsample2x_conv3x3_reference)(x, k, b, act))


def _f64(shape, seed, scale=1.0):
    return torch.from_numpy(_np(shape, seed).astype(np.float64) * scale).requires_grad_(True)


def test_rdb5c_fn_gradcheck(plain_launch):
    nf, gc = 4, 2
    x = _f64((1, 5, 4, nf), 30)
    wb = []
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        wb += [_f64((3, 3, cin, cout), 30 + k, 0.3), _f64((cout,), 40 + k, 0.1)]
    assert torch.autograd.gradcheck(fns.Rdb5cFn.apply, (x, *wb), eps=1e-6, atol=1e-6)
    y = fns.Rdb5cFn.apply(x, *wb)
    assert len(y.grad_fn.saved_tensors) == 11  # the input and the ten parameters, nothing else


@pytest.mark.parametrize("fn", ["conv3x3", "upsample2x"])
@pytest.mark.parametrize("act", [False, True])
def test_conv_fns_gradcheck(plain_launch, fn, act):
    x, k, b = _f64((2, 4, 5, 3), 50), _f64((3, 3, 3, 2), 51, 0.5), _f64((2,), 52, 0.1)
    f = {"conv3x3": fns.Conv3x3Fn, "upsample2x": fns.Upsample2xConvFn}[fn]
    assert torch.autograd.gradcheck(lambda *a: f.apply(*a, act), (x, k, b), eps=1e-6, atol=1e-6)
    # a conv without bias, and an input that needs no gradient
    y = f.apply(x.detach(), k, None, act)
    (gk,) = torch.autograd.grad(y.sum(), k)
    plain = conv3x3_reference if fn == "conv3x3" else upsample2x_conv3x3_reference
    (want,) = torch.autograd.grad(plain(x.detach(), k, None, act).sum(), k)
    torch.testing.assert_close(gk, want)
