"""The port's KernelGAN-style kernel estimator (esr_tpu_torch.cem.kernelgan)
against the JAX package's (esr_tpu.cem.kernelgan), on the CPU in f32.

- ``effective_kernel`` is exact: G(x, stride=False) equals one VALID
  correlation with it to 1e-5 everywhere, the strided G is its ``::s``
  subsample bit for bit, and it equals JAX's on the same weights (1e-6).
- The regularizers and the LSGAN loss equal JAX's in value (rel 1e-6) and
  gradient (1e-5 of the largest: sums over the 441 taps in another order),
  with exact zeros in the kernel (JAX's
  ``|.|`` gradient at 0).
- Three (G, D) steps fed JAX's own crops (``_rand_crop`` on JAX's split
  keys) match JAX's losses and parameters at rel 1e-5; the supervised step
  likewise. Longer runs are not compared: Adam's ratio of nearly cancelled
  moments lets f32 rounding part the trajectories.
- The supervised probe of tests/test_kernelgan.py, on the port's own crops
  and init: aligned correlation > 0.88; its step takes cuDNN's deterministic
  algorithms.
- ``conf_for_image`` and the size checks raise as JAX's do.
- The loop in two parts (host: a chunk's offsets and step scalars; device:
  the crops gathered at device offsets and the updates, one CUDA graph on
  the card): the gather equals the slice crop bit for bit, the staged step
  equals the one-call step, and ``estimate_kernel`` equals a copy of the
  eager loop it replaced bit for bit over 250 iterations (a ragged last
  chunk), eagerly and through a stand-in for the graph's capture and replay
  (tests/torch_fake_graphs.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax.training.train_state import TrainState

import torch_fake_graphs

from esr_tpu.cem import kernelgan as jkg
from esr_tpu.scripts.blind_bench import aligned_corr, gaussian_kernel
from esr_tpu_torch.cem import kernelgan as kg
from esr_tpu_torch.device import full_f32
from esr_tpu_torch.models import kernelgan_state_dict_from_jax
from esr_tpu_torch.models.base_model import Adam

torch.set_num_threads(1)

TINY = dict(scale=4, g_kernels=(7, 5, 3, 1), g_channels=16, d_kernels=(5, 1, 1), d_channels=16, g_input=32,
            iters=100)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_nets(conf, seed=1):
    g, d = jkg.LinearKernelG(conf), jkg.PatchD(conf)
    g_params = g.init(jax.random.PRNGKey(seed), jnp.zeros((1, conf.g_input, conf.g_input, 1)))["params"]
    fs = jkg._fake_size(conf)
    d_params = d.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, fs, fs, 1)))["params"]
    return g, d, g_params, d_params


def _port_nets(conf, g_params, d_params=None):
    g = kg.LinearKernelG(kg.KernelGANConf(**conf.__dict__))
    g.load_state_dict(kernelgan_state_dict_from_jax(jax.device_get(g_params)), strict=True)
    d = None
    if d_params is not None:
        d = kg.PatchD(kg.KernelGANConf(**conf.__dict__))
        d.load_state_dict(kernelgan_state_dict_from_jax(jax.device_get(d_params)), strict=True)
    return g, d


def test_effective_kernel_is_exact():
    conf = jkg.KernelGANConf(**TINY)
    jg, _, g_params, _ = _jax_nets(conf)
    g, _ = _port_nets(conf, g_params)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 1)).astype(np.float32))
    with torch.no_grad():
        k = kg.effective_kernel(g, kg.KernelGANConf(**TINY))
        flat = g(x, stride=False)
        want = F.conv2d(x.permute(0, 3, 1, 2), k[None, None]).permute(0, 2, 3, 1)
        strided = g(x)
    assert tuple(k.shape) == (13, 13) and tuple(flat.shape) == (1, 52, 52, 1)
    np.testing.assert_allclose(flat.numpy(), want.numpy(), atol=1e-5)
    assert torch.equal(strided, flat[:, ::4, ::4])
    np.testing.assert_allclose(k.numpy(), np.asarray(jkg.effective_kernel(jg, g_params, conf)), atol=1e-6)
    np.testing.assert_allclose(g(x).detach().numpy(), np.asarray(jg.apply({"params": g_params}, jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("sparse", [0.0, 0.3])
def test_regularizers_and_lsgan_match_jax(sparse):
    conf = kg.KernelGANConf(w_sparse=sparse)
    jconf = jkg.KernelGANConf(w_sparse=sparse)
    rng = np.random.default_rng(3)
    k = rng.normal(0, 0.05, (21, 21)).astype(np.float32)
    k[10, 10] = 0.6
    k[0, :5] = 0.0  # exact zeros: |.| at 0
    want, jgrad = jax.value_and_grad(lambda a: jkg._kernel_regularizers(a, jconf))(jnp.asarray(k))
    kt = torch.from_numpy(k).requires_grad_(True)
    got = kg._kernel_regularizers(kt, conf)
    (grad,) = torch.autograd.grad(got, kt)
    got = got.detach()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-5 * float(np.abs(jgrad).max()))
    logits = rng.normal(size=(1, 5, 5, 1)).astype(np.float32)
    for target in (0.0, 1.0):
        assert abs(float(kg._lsgan(torch.from_numpy(logits), target))
                   - float(jkg._lsgan(jnp.asarray(logits), target))) <= 1e-6


def _jax_state(module, params, lr):
    return TrainState.create(apply_fn=module.apply, params=params, tx=optax.adam(lr, b1=0.5))


def test_three_steps_match_jax_on_jax_crops():
    """make_kernelgan_step fed the crops JAX's step draws: after each step the
    four losses (rel 1e-5), after three G's and D's parameters (rel 1e-5)."""
    conf = jkg.KernelGANConf(**TINY)
    pconf = kg.KernelGANConf(**TINY)
    img = np.random.default_rng(4).random((48, 56, 1)).astype(np.float32)
    jimg = jnp.asarray(img)
    jg, jd, g_params, d_params = _jax_nets(conf)
    g, d = _port_nets(conf, g_params, d_params)
    g_state, d_state = _jax_state(jg, g_params, conf.lr_g), _jax_state(jd, d_params, conf.lr_d)
    jstep = jax.jit(jkg.make_kernelgan_step(jg, jd, conf))
    pstep = kg.make_kernelgan_step(g, d, pconf, Adam(g.parameters(), b1=0.5), Adam(d.parameters(), b1=0.5))
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        rng_real, rng_fake = jax.random.split(rng)
        g_in = np.array(jkg._rand_crop(jimg, rng_fake, conf.g_input))
        real = np.array(jkg._rand_crop(jimg, rng_real, jkg._fake_size(conf)))
        g_state, d_state, jm = jstep(g_state, d_state, jimg, rng)
        pm = pstep(torch.from_numpy(g_in), torch.from_numpy(real))
        for key, v in jax.device_get(jm).items():
            assert abs(float(pm[key]) - float(v)) <= 1e-5 * abs(float(v)), (i, key, float(pm[key]), float(v))
    for net, params in ((g, g_state.params), (d, d_state.params)):
        want = kernelgan_state_dict_from_jax(jax.device_get(params))
        for name, v in net.state_dict().items():
            assert _rel(v.numpy(), want[name].numpy()) <= 1e-5, name


def test_override_step_matches_jax():
    """The supervised step (no D): two steps on JAX's crops; the losses (rel
    1e-5 at step 1, 1e-4 at step 2, where the L2 to a half-scale target
    magnifies step 1's rounding) and G after both (rel 1e-5)."""
    conf = jkg.KernelGANConf(**TINY)
    img = jnp.asarray(np.random.default_rng(5).random((40, 40, 1)).astype(np.float32))
    jg, _, g_params, _ = _jax_nets(conf)
    g, _ = _port_nets(conf, g_params)

    def jloss(fake, g_in):
        return jnp.mean((fake - 0.5 * g_in[:, 6::4, 6::4][:, : fake.shape[1], : fake.shape[2]]) ** 2)

    def ploss(fake, g_in):
        return torch.mean((fake - 0.5 * g_in[:, 6::4, 6::4][:, : fake.shape[1], : fake.shape[2]]) ** 2)

    g_state = _jax_state(jg, g_params, conf.lr_g)
    jstep = jax.jit(jkg._override_step(jg, conf, jloss))
    pstep = kg.make_override_step(g, kg.KernelGANConf(**TINY), Adam(g.parameters(), b1=0.5), ploss)
    for i in range(2):
        rng = jax.random.PRNGKey(7 + i)
        g_in = np.array(jkg._rand_crop(img, jax.random.split(rng)[1], conf.g_input))
        g_state, _, jm = jstep(g_state, None, img, rng)
        pm = pstep(torch.from_numpy(g_in))
        for key in ("l_g", "adv", "reg"):  # the step-2 loss sums the step-1 update's rounding
            assert abs(float(pm[key]) - float(jm[key])) <= (1e-5 if i == 0 else 1e-4) * abs(float(jm[key])), (i, key)
        assert float(pm["l_d"]) == 0.0
    want = kernelgan_state_dict_from_jax(jax.device_get(g_state.params))
    for name, v in g.state_dict().items():
        assert _rel(v.numpy(), want[name].numpy()) <= 1e-5, name


def test_supervised_recovery():
    """tests/test_kernelgan.py's supervised probe on the port (its crops, its
    init): the L2-to-oracle estimator recovers the anisotropic Gaussian,
    aligned correlation > 0.88, unit sum."""
    k_true = gaussian_kernel()
    img = np.random.default_rng(2).random((96, 96)).astype(np.float32)
    kt = torch.tensor(k_true, dtype=torch.float32)[None, None]

    def loss_override(fake, g_in):  # the centred SAME oracle on G's phase
        full = F.conv2d(g_in.permute(0, 3, 1, 2), kt, padding=6).permute(0, 2, 3, 1)
        return torch.mean((fake - full[:, 6::4, 6::4][:, : fake.shape[1], : fake.shape[2]]) ** 2)

    conf = kg.KernelGANConf(**dict(TINY, iters=1000), lr_g=2e-3, w_centralized=0.1, w_boundaries=0.1)
    calls = []
    k_est, metrics = kg.estimate_kernel(img, conf, progress=lambda *a: calls.append(a[:2]),
                                        loss_override=loss_override, device="cpu")
    assert abs(k_est.sum() - 1.0) < 1e-6 and k_est.dtype == np.float64
    assert calls == [(100 * i, 1000) for i in range(1, 11)]
    assert aligned_corr(k_est, k_true) > 0.88, (aligned_corr(k_est, k_true), metrics)


def test_supervised_step_takes_deterministic_cudnn():
    """The supervised step runs its convs (G, the loss, the backward) with
    cuDNN's deterministic algorithms and TF32 off, so that the probe repeats
    bit for bit on the card; the caller's flags come back after."""
    conf = kg.KernelGANConf(**TINY)
    g = kg.LinearKernelG(conf)
    cudnn = torch.backends.cudnn
    seen = []

    def loss(fake, g_in):
        seen.append((cudnn.deterministic, cudnn.allow_tf32))
        return torch.mean(fake**2)

    step = kg.make_override_step(g, conf, Adam(g.parameters(), b1=0.5), loss)
    before = (cudnn.deterministic, cudnn.allow_tf32)
    step(torch.rand(1, conf.g_input, conf.g_input, 1, generator=torch.Generator().manual_seed(0)))
    assert seen == [(True, False)]
    assert (cudnn.deterministic, cudnn.allow_tf32) == before

def test_adversarial_estimate_runs_in_chunks():
    """The adversarial path at TINY: progress after every chunk of 100 and at
    the end, finite losses, a unit-sum 13 x 13 kernel; the same seed gives
    the same kernel."""
    img = np.random.default_rng(6).random((40, 44, 3)).astype(np.float32)
    calls = []
    conf = kg.KernelGANConf(**dict(TINY, iters=150))
    k1, m = kg.estimate_kernel(img, conf, progress=lambda d, t, mm: calls.append((d, t, sorted(mm))),
                               device="cpu")
    assert [c[:2] for c in calls] == [(100, 150), (150, 150)] and calls[0][2] == ["adv", "l_d", "l_g", "reg"]
    assert np.isfinite(list(m.values())).all() and k1.shape == (13, 13) and abs(k1.sum() - 1) < 1e-6
    k2, _ = kg.estimate_kernel(img, conf, device="cpu")
    np.testing.assert_array_equal(k1, k2)


def test_conf_for_image_and_size_checks_match_jax():
    for shape in ((100, 100), (50, 60), (48, 200)):
        assert kg.conf_for_image(shape, 4).__dict__ == jkg.conf_for_image(shape, 4).__dict__
    assert kg.conf_for_image((100, 100), 4).g_input == 64 and kg.conf_for_image((50, 60), 4).g_input == 48
    for mod in (kg, jkg):
        with pytest.raises(ValueError, match="too small"):
            mod.conf_for_image((40, 40), 4)
    with pytest.raises(ValueError, match="smaller than g_input"):
        kg.estimate_kernel(np.zeros((16, 16)), kg.KernelGANConf(**TINY), device="cpu")
    with pytest.raises(ValueError, match="composite G support"):
        kg.estimate_kernel(np.zeros((64, 64)), kg.KernelGANConf(**dict(TINY, g_input=12)), device="cpu")
    with pytest.raises(ValueError, match="receptive field"):
        kg.estimate_kernel(np.zeros((64, 64)), kg.KernelGANConf(**dict(TINY, g_input=20)), device="cpu")
    assert (kg._support(kg.KernelGANConf()), kg._d_receptive(kg.KernelGANConf()),
            kg._fake_size(kg.KernelGANConf())) == (21, 7, 11)


def test_estimate_kernel_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kg.estimate_kernel(np.zeros((64, 64)), kg.KernelGANConf(**TINY))


# -- the loop in two parts ----------------------------------------------------------------


def _one_call_steps(g, d, conf, g_opt, d_opt, loss_override):
    """The one-call steps the two-part ones replaced: each Adam stages its
    learning rate in ``step(grads, lr)`` itself."""

    def adversarial(g_in, real):
        with full_f32(), torch.enable_grad():
            fake = g(g_in)
            adv = kg._lsgan(d(fake), 1.0)
            reg = kg._kernel_regularizers(kg.effective_kernel(g, conf), conf)
            l_g = adv + reg
            g_grads = torch.autograd.grad(l_g, g_opt.params)
        g_opt.step(list(g_grads), conf.lr_g)
        fake = fake.detach()
        with full_f32(), torch.enable_grad():
            l_d = (kg._lsgan(d(real), 1.0) + kg._lsgan(d(fake), 0.0)) / 2.0
            d_grads = torch.autograd.grad(l_d, d_opt.params)
        d_opt.step(list(d_grads), conf.lr_d)
        return {"l_g": l_g.detach(), "l_d": l_d.detach(), "adv": adv.detach(), "reg": reg.detach()}

    def override(g_in):
        with full_f32(deterministic=True), torch.enable_grad():
            fake = g(g_in)
            main = loss_override(fake, g_in)
            reg = kg._kernel_regularizers(kg.effective_kernel(g, conf), conf)
            l_g = main + reg
            g_grads = torch.autograd.grad(l_g, g_opt.params)
        g_opt.step(list(g_grads), conf.lr_g)
        return {"l_g": l_g.detach(), "l_d": torch.zeros_like(l_g), "adv": main.detach(), "reg": reg.detach()}

    return override if loss_override is not None else adversarial


def _eager_loop(lr_image, conf, progress=None, loss_override=None):
    """The estimator's loop before it was split in two: Python-int slice
    crops and the one-call steps, on the CPU."""
    img = np.asarray(lr_image, np.float32)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    h, w = img.shape
    img_t = torch.from_numpy(np.ascontiguousarray(img[..., None]))
    g = kg.LinearKernelG(conf, seed=conf.seed)
    g_opt = Adam(g.parameters(), b1=0.5)
    d = d_opt = None
    if loss_override is None:
        d = kg.PatchD(conf, seed=conf.seed + 1)
        d_opt = Adam(d.parameters(), b1=0.5)
    step = _one_call_steps(g, d, conf, g_opt, d_opt, loss_override)
    fake = kg._fake_size(conf)
    gen = torch.Generator().manual_seed(conf.seed)
    metrics = {}
    for lo in range(0, conf.iters, kg.CHUNK):
        n = min(kg.CHUNK, conf.iters - lo)
        oy = torch.randint(0, h - conf.g_input + 1, (n, 1), generator=gen)
        ox = torch.randint(0, w - conf.g_input + 1, (n, 1), generator=gen)
        ry = torch.randint(0, h - fake + 1, (n, 1), generator=gen)
        rx = torch.randint(0, w - fake + 1, (n, 1), generator=gen)
        for fy, fx, y, x in torch.cat([oy, ox, ry, rx], 1).tolist():
            g_in = img_t[fy : fy + conf.g_input, fx : fx + conf.g_input][None]
            m = step(g_in) if loss_override is not None else step(g_in, img_t[y : y + fake, x : x + fake][None])
        metrics = dict(zip(m, torch.stack(list(m.values())).tolist()))
        if progress is not None:
            progress(lo + n, conf.iters, dict(metrics))
    with torch.no_grad():
        k = kg.effective_kernel(g, conf).double().numpy()
    if k.sum() <= 1e-8:
        k = np.abs(k)
    return k / k.sum(), metrics


def _half_scale_loss(fake, g_in):
    return torch.mean((fake - 0.5 * g_in[:, 6::4, 6::4][:, : fake.shape[1], : fake.shape[2]]) ** 2)


@pytest.mark.parametrize("shape", [(40, 44), (37, 53), (64, 49)])
def test_gather_crop_equals_slice_crop(shape):
    """The device gather at tensor offsets is the slice crop, bit for bit,
    on random offsets of ragged images, at G's and D's crop sizes."""
    rng = np.random.default_rng(sum(shape))
    img = torch.from_numpy(np.ascontiguousarray(rng.random(shape).astype(np.float32)[..., None]))
    for size in (32, kg._fake_size(kg.KernelGANConf(**TINY))):
        span = torch.arange(size)
        for _ in range(20):
            oy, ox = int(rng.integers(0, shape[0] - size + 1)), int(rng.integers(0, shape[1] - size + 1))
            got = kg._gather_crop(img, torch.tensor(oy), torch.tensor(ox), span)
            want = kg._crop(img, oy, ox, size)
            assert got.shape == want.shape == (1, size, size, 1) and torch.equal(got, want), (oy, ox, size)
            assert got.stride(-1) == want.stride(-1), (got.stride(), want.stride())


@pytest.mark.parametrize("supervised", [False, True], ids=["adversarial", "override"])
def test_staged_step_equals_one_call_step(supervised):
    """make_kernelgan_step / make_override_step (scalars staged by the host,
    then the device part) == the one-call steps, bit for bit over 3 steps:
    metrics, weights and Adam moments."""
    conf = kg.KernelGANConf(**TINY)
    runs = []
    for staged in (True, False):
        g, d = kg.LinearKernelG(conf, seed=3), kg.PatchD(conf, seed=4)
        g_opt, d_opt = Adam(g.parameters(), b1=0.5), Adam(d.parameters(), b1=0.5)
        loss = _half_scale_loss if supervised else None
        if staged:
            step = (kg.make_override_step(g, conf, g_opt, loss) if supervised
                    else kg.make_kernelgan_step(g, d, conf, g_opt, d_opt))
        else:
            step = _one_call_steps(g, d, conf, g_opt, d_opt, loss)
        metrics = []
        for i in range(3):
            crops = np.random.default_rng(100 + i)
            g_in = torch.from_numpy(crops.random((1, 32, 32, 1)).astype(np.float32))
            real = torch.from_numpy(crops.random((1, 5, 5, 1)).astype(np.float32))
            metrics.append({k: v.clone() for k, v in (step(g_in) if supervised else step(g_in, real)).items()})
        runs.append((metrics, [p.detach().clone() for p in (*g.parameters(), *d.parameters())],
                     [t.clone() for opt in (g_opt, d_opt) for t in (*opt.mu, *opt.nu)], g_opt.count))
    (m1, p1, s1, c1), (m2, p2, s2, c2) = runs
    assert c1 == c2 == 3
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m1, m2) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p1 + s1, p2 + s2))


@pytest.mark.parametrize("supervised", [False, True], ids=["adversarial", "override"])
@pytest.mark.parametrize("graphs", ["eager", "fake_capture"])
def test_estimate_kernel_equals_the_eager_loop(supervised, graphs, monkeypatch):
    """estimate_kernel on the CPU == the loop it replaced (Python-int slice
    crops, one-call steps), bit for bit over 250 iterations (chunks of 100,
    100, 50): the kernel, the last metrics and every progress call; the same
    through the graph stand-in (one capture, 249 replays)."""
    captured = torch_fake_graphs.install(monkeypatch) if graphs == "fake_capture" else []
    img = np.random.default_rng(6).random((40, 44, 3)).astype(np.float32)
    conf = kg.KernelGANConf(**dict(TINY, iters=250))
    loss = _half_scale_loss if supervised else None
    calls, want_calls = [], []
    got = kg.estimate_kernel(img, conf, progress=lambda *a: calls.append(a), loss_override=loss, device="cpu")
    want = _eager_loop(img, conf, progress=lambda *a: want_calls.append(a), loss_override=loss)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and calls == want_calls and [c[0] for c in calls] == [100, 200, 250]
    assert len(captured) == (1 if graphs == "fake_capture" else 0)
