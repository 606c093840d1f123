"""The port's Z-search objectives against esr_tpu.explore.objectives.

Each objective's value and its gradient with respect to ``sr`` on the same
numpy inputs (f32, a (1, 64, 64, 3) image, a rectangular region), at rtol
1e-5 (gradients: plus an atol of 1e-5 of the gradient's largest element, for
elements that cancel to near zero). The inputs are quantized to a few levels
so that differences of exactly zero occur, where ``|.|``'s gradient is JAX's
1, not torch's 0. Also: ``jax_abs`` at 0, the bilinear antialiased resize of
the realism tool against ``jax.image.resize`` (64 -> 128, 512 -> 128), and
``crop_hr``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.explore import objectives as J
from esr_tpu.models.architecture import DiscriminatorVGG128 as JD
from esr_tpu_torch.explore import objectives as P
from esr_tpu_torch.models.architecture import DiscriminatorVGG128
from esr_tpu_torch.models.networks import discriminator_state_dict_from_jax

torch.set_num_threads(1)

RTOL = 1e-5


def _inputs(seed=0, size=64, levels=8):
    rng = np.random.default_rng(seed)
    sr = (np.round(rng.random((1, size, size, 3)) * levels) / levels).astype(np.float32)
    mask = np.zeros((size, size), np.float32)
    mask[10:50, 6:40] = 1.0
    return sr, mask


def _jax_value_grad(obj, sr, mask):
    fn, aux = obj.fn, obj.aux or {}
    v, g = jax.value_and_grad(lambda s: fn(s, jnp.asarray(mask), aux))(jnp.asarray(sr))
    return float(v), np.asarray(g)


def _port_value_grad(obj, sr, mask):
    s = torch.from_numpy(sr).requires_grad_(True)
    v = obj(s, torch.from_numpy(mask))
    (g,) = torch.autograd.grad(v, s)
    return float(v.detach()), g.numpy()


def _check(jobj, pobj, sr, mask):
    jv, jg = _jax_value_grad(jobj, sr, mask)
    pv, pg = _port_value_grad(pobj, sr, mask)
    np.testing.assert_allclose(pv, jv, rtol=RTOL)
    np.testing.assert_allclose(pg, jg, rtol=RTOL, atol=RTOL * float(np.abs(jg).max()))
    return jg


def test_jax_abs_gradient_at_zero():
    """``jax_abs`` has JAX's gradient of ``jnp.abs`` at 0 (1), where torch's
    ``abs`` has 0; elsewhere the sign, and the value is ``|x|``."""
    x = np.array([0.0, -0.0, 1.5, -2.0], np.float32)
    want = np.asarray(jax.vmap(jax.grad(jnp.abs))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(P.jax_abs(t).sum(), t)
    np.testing.assert_array_equal(g.numpy(), want)
    np.testing.assert_array_equal(P.jax_abs(t).detach().abs().numpy(), np.abs(x))
    (g_torch,) = torch.autograd.grad(t.abs().sum(), t)
    assert g_torch[0] == 0 and want[0] == 1  # the difference jax_abs exists for


def test_imprint_with_exact_matches():
    """Half of the target equals sr exactly: JAX's |.| pushes there too."""
    sr, mask = _inputs(1)
    target = sr[0].copy()
    target[:, 32:] = np.round(np.random.default_rng(2).random((64, 32, 3)) * 4) / 4
    g = _check(J.imprint_objective(jnp.asarray(target)), P.imprint_objective(target), sr, mask)
    assert np.abs(g[0, 10:50, 6:32]).min() > 0  # the exact-match pixels get a gradient


@pytest.mark.parametrize("direction", [1.0, -1.0])
@pytest.mark.parametrize("window", [7, 5])
def test_variance(direction, window):
    sr, mask = _inputs(3, levels=16)
    _check(J.variance_objective(direction, window), P.variance_objective(direction, window), sr, mask)


@pytest.mark.parametrize("level", [0.25, 0.8])
def test_brightness(level):
    sr, mask = _inputs(4)
    _check(J.brightness_objective(level), P.brightness_objective(level), sr, mask)


def test_tv_with_flat_runs():
    sr, mask = _inputs(5, levels=2)  # many neighbours equal: |0| everywhere
    _check(J.tv_objective(), P.tv_objective(), sr, mask)


@pytest.mark.parametrize("py,px", [(0.0, 5.0), (3.0, 0.0), (2.5, 4.0), (-1.5, 0.0)])
def test_periodicity(py, px):
    """The objective the tool builds (periods as parameters), and the static
    form on the same shift, in both packages."""
    sr, mask = _inputs(6, levels=4)
    _check(J.periodicity_objective(py, px), P.periodicity_objective(py, px), sr, mask)
    shifts = tuple((d, 0.0) if axis == 0 else (0.0, d) for axis, d in enumerate((py, px)) if d)
    jv, jg = _jax_value_grad(J.Objective(J._periodicity_fn(shifts)), sr, mask)
    pv, pg = _port_value_grad(P.Objective(P._periodicity_fn(shifts)), sr, mask)
    np.testing.assert_allclose(pv, jv, rtol=RTOL)
    np.testing.assert_allclose(pg, jg, rtol=RTOL, atol=RTOL * float(np.abs(jg).max()))
    dv, _ = _port_value_grad(P.periodicity_objective(py, px), sr, mask)
    np.testing.assert_allclose(pv, dv, rtol=RTOL)  # the two forms agree
    jv2, _ = _jax_value_grad(J.Objective(J._periodicity_fn(((py, px),))), sr, mask)
    pv2, _ = _port_value_grad(P.Objective(P._periodicity_fn(((py, px),))), sr, mask)
    np.testing.assert_allclose(pv2, jv2, rtol=RTOL)  # a 2-D shift


def test_random_diverse_with_padded_anchors():
    sr, mask = _inputs(7)
    rng = np.random.default_rng(8)
    anchors = np.zeros((4, 64, 64, 3), np.float32)
    anchors[:2] = np.round(rng.random((2, 64, 64, 3)) * 8) / 8
    anchors[1, :32] = sr[0, :32]  # exact matches
    w = np.array([1, 1, 0, 0], np.float32)
    _check(J.random_diverse_objective(jnp.asarray(anchors), 1.5, jnp.asarray(w)),
           P.random_diverse_objective(anchors, 1.5, w), sr, mask)
    # zero-weight padding changes nothing
    pv, _ = _port_value_grad(P.random_diverse_objective(anchors[:2], 1.5), sr, mask)
    pv_pad, _ = _port_value_grad(P.random_diverse_objective(anchors, 1.5, w), sr, mask)
    np.testing.assert_allclose(pv_pad, pv, rtol=RTOL)


@pytest.mark.parametrize("n_bins,sigma", [(32, 0.05), (16, 0.1)])
def test_histogram(n_bins, sigma):
    sr, mask = _inputs(9, levels=64)
    patch = np.random.default_rng(10).random((20, 12, 3)).astype(np.float32) ** 2
    _check(J.histogram_objective(jnp.asarray(patch), n_bins, sigma), P.histogram_objective(patch, n_bins, sigma),
           sr, mask)


@pytest.mark.parametrize("n_in,shape", [(64, (1, 64, 64, 3)), (512, (1, 512, 512, 3)), (96, (2, 96, 40, 3))])
def test_resize_bilinear_matches_jax_image_resize(n_in, shape):
    """The realism tool's resize to D's input (128): ``jax.image.resize``
    bilinear with its default antialias, upsampling and downsampling; value
    and gradient."""
    x = np.random.default_rng(n_in).random(shape).astype(np.float32)
    out = (shape[0], 128, 128, shape[3])
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "bilinear"))
    t = torch.from_numpy(x).requires_grad_(True)
    got = P.resize_bilinear(t, 128, 128)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=1e-6)
    gy = np.random.default_rng(1).standard_normal(out).astype(np.float32)
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jax.image.resize(a, out, "bilinear") * gy))(jnp.asarray(x)))
    (pg,) = torch.autograd.grad(got, t, torch.from_numpy(gy))
    np.testing.assert_allclose(pg.numpy(), jg, rtol=RTOL, atol=RTOL * float(np.abs(jg).max()))


@pytest.fixture(scope="module")
def discriminators():
    """A JAX DiscriminatorVGG128 (nf 4, trained input 128) with non-trivial
    running statistics, and the port's on the same weights."""
    jd = JD(in_nc=3, nf=4, norm="batch")
    variables = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False)
    rng = np.random.default_rng(11)
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
                                   variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    d = DiscriminatorVGG128(in_nc=3, nf=4, norm="batch", hr_size=(128, 128))
    d.load_state_dict(discriminator_state_dict_from_jax(variables, hr_size=128), strict=True)
    return variables, d.requires_grad_(False)


@pytest.mark.parametrize("size,direction", [(64, 1.0), (256, -1.0), (128, 1.0)])
def test_adversarial(discriminators, size, direction):
    """The realism objective through D, the crop resized to D's input (read
    from D's head: 128) when it differs, gradients only through the region."""
    variables, d = discriminators
    sr, mask = _inputs(12, size=size, levels=32)
    mask = np.zeros((size, size), np.float32)
    mask[size // 4 : size // 2, size // 8 : 3 * size // 4] = 1.0
    assert P.d_input_size(d) == 128
    g = _check(J.adversarial_objective(variables, direction, nf=4), P.adversarial_objective(d, direction), sr, mask)
    assert not g[0][mask == 0].any()


def test_crop_hr():
    """Spatial aux (imprint target, anchors) is cropped to the HR window; the
    others are kept."""
    rng = np.random.default_rng(13)
    target = rng.random((64, 48, 3)).astype(np.float32)
    anchors = rng.random((3, 64, 48, 3)).astype(np.float32)
    for jo, po in ((J.imprint_objective(jnp.asarray(target)), P.imprint_objective(target)),
                   (J.random_diverse_objective(jnp.asarray(anchors)), P.random_diverse_objective(anchors))):
        jc, pc = jo.crop_hr(8, 12, 32), po.crop_hr(8, 12, 32)
        for k in po.spatial:
            np.testing.assert_array_equal(pc.aux[k].numpy(), np.asarray(jc.aux[k]))
    tv = P.tv_objective()
    assert tv.crop_hr(0, 0, 16) is tv
