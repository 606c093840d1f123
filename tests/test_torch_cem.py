"""The port's CEM (esr_tpu_torch.cem) against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both; f32 throughout. Values
must match JAX at atol 1e-5 (both compute the same f32 matmuls from the same
f64-built matrices), and H(project(x)) must equal lr to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.cem import CEMConf as JCEMConf
from esr_tpu.cem import make_cem as jmake_cem
from esr_tpu.cem import kernels as jkernels
from esr_tpu.ops.resize import resize_matrix as jresize_matrix
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.cem import kernels as tkernels
from esr_tpu_torch.ops.resize import resize_matrix

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.fixture(scope="module")
def cems():
    return make_cem(CEMConf(scale=4), device="cpu"), jmake_cem(JCEMConf(scale=4))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "in_len,out_len,antialias",
    [(64, 16, True), (37, 111, True), (48, 12, False), (17, 17, True), (30, 7, True)],
)
def test_resize_matrix_equals_jax(in_len, out_len, antialias):
    for dtype in (np.float32, np.float64):
        got = resize_matrix(in_len, out_len, antialias, dtype=dtype)
        ref = jresize_matrix(in_len, out_len, antialias, dtype=dtype)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 8])
def test_downsample_kernels_equal_jax(scale):
    k, rel = tkernels.bicubic_downsample_kernel_1d(scale)
    jk, jrel = jkernels.bicubic_downsample_kernel_1d(scale)
    np.testing.assert_array_equal(k, jk)
    assert rel == jrel
    k2, rel2 = tkernels.downsample_kernel_2d(scale)
    jk2, jrel2 = jkernels.downsample_kernel_2d(scale)
    np.testing.assert_array_equal(k2, jk2)
    assert rel2 == jrel2
    q, c = tkernels.lr_autocorrelation(k2, scale)
    jq, jc = jkernels.lr_autocorrelation(jk2, scale)
    np.testing.assert_array_equal(q, jq)
    assert c == jc


def test_resolve_kernel_equals_jax(tmp_path):
    arr = np.outer(np.hanning(7), np.hanning(7))
    np.save(tmp_path / "k.npy", arr)
    for form in (None, "", [], [1.0, 2.0, 1.0], arr, str(tmp_path / "k.npy")):
        assert tkernels.resolve_kernel(form) == jkernels.resolve_kernel(form)


def test_matmul_ops_match_jax(cems):
    """downsample, dt_satisfying_upscale and project equal JAX's (non-square, batch 2)."""
    cem, jcem = cems
    rng = np.random.default_rng(0)
    hr = rng.random((2, 48, 40, 3)).astype(np.float32) * 3 - 1
    lr = rng.random((2, 12, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        cem.downsample(_t(hr)).numpy(), np.asarray(jcem.downsample(jnp.asarray(hr))), atol=ATOL
    )
    np.testing.assert_allclose(
        cem.dt_satisfying_upscale(_t(lr)).numpy(),
        np.asarray(jcem.dt_satisfying_upscale(jnp.asarray(lr))),
        atol=ATOL,
    )
    np.testing.assert_allclose(
        cem.project(_t(hr), _t(lr)).numpy(),
        np.asarray(jcem.project(jnp.asarray(hr), jnp.asarray(lr))),
        atol=ATOL,
    )


def test_consistency_invariant(cems):
    """H(project(g, lr)) == lr for arbitrary generator output g, to 1e-5."""
    cem, _ = cems
    rng = np.random.default_rng(2)
    lr = _t(rng.random((2, 12, 14, 3)).astype(np.float32))
    g = _t(rng.random((2, 48, 56, 3)).astype(np.float32) * 3 - 1)
    err = (cem.downsample(cem.project(g, lr)) - lr).abs().max().item()
    assert err <= ATOL, err
    lf = cem.dt_satisfying_upscale(lr)
    assert (cem.downsample(lf) - lr).abs().max().item() <= ATOL


def test_projection_idempotent(cems):
    cem, _ = cems
    rng = np.random.default_rng(4)
    lr = _t(rng.random((1, 12, 12, 1)).astype(np.float32))
    g = _t(rng.random((1, 48, 48, 1)).astype(np.float32))
    once = cem.project(g, lr)
    np.testing.assert_allclose(cem.project(once, lr).numpy(), once.numpy(), atol=ATOL)


def test_enforce_dt_on_image_pair(cems):
    cem, _ = cems
    rng = np.random.default_rng(6)
    hr = _t(rng.random((1, 32, 32, 3)).astype(np.float32))
    lr = _t(rng.random((1, 8, 8, 3)).astype(np.float32))
    fixed = cem.enforce_dt_on_image_pair(lr, hr)
    assert (cem.downsample(fixed) - lr).abs().max().item() <= ATOL


@pytest.mark.parametrize("pad", [0, 2])
def test_wrap_and_pad_lr_crop_match_jax(pad):
    """wrap(apply_fn) with and without pad_lr: same shape and values as JAX's
    wrap, and consistent (in the interior when padded)."""
    cem = make_cem(CEMConf(scale=4, pad_lr=pad), device="cpu")
    jcem = jmake_cem(JCEMConf(scale=4, pad_lr=pad))
    rng = np.random.default_rng(8)
    lr = rng.random((1, 12, 10, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (1, 12, 10, 1)).astype(np.float32)

    def fake_g(lr_, z_):
        up = lr_.repeat_interleave(4, 1).repeat_interleave(4, 2)
        return up + 0.1 * z_.repeat_interleave(4, 1).repeat_interleave(4, 2)

    def jfake_g(params, lr_, z_):
        up = jnp.repeat(jnp.repeat(lr_, 4, axis=1), 4, axis=2)
        return up + 0.1 * jnp.repeat(jnp.repeat(z_, 4, axis=1), 4, axis=2)

    out = cem.wrap(fake_g)(_t(lr), _t(z))
    ref = jcem.wrap(jfake_g)(None, jnp.asarray(lr), jnp.asarray(z))
    assert tuple(out.shape) == (1, 48, 40, 3) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    back = make_cem(CEMConf(scale=4), device="cpu").downsample(out).numpy()
    m = pad
    np.testing.assert_allclose(back[0, m:12 - m, m:10 - m], lr[0, m:12 - m, m:10 - m],
                               atol=ATOL if pad == 0 else 1e-4)


@pytest.mark.parametrize("mode", ["fft", "filter"])
def test_unported_inv_modes_raise(mode):
    """The fft and filter modes, which raised until blind SR was ported, now
    build (tests/test_torch_cem_modes.py holds them against JAX): by name,
    and fft as ``auto``'s choice for a 2-D kernel, as in the JAX package."""
    assert make_cem(CEMConf(scale=4, inv_mode=mode), device="cpu")._mode == mode
    g1 = np.exp(-0.5 * (np.arange(9) - 4.0) ** 2 / 4.0)
    k2 = tuple(map(tuple, np.outer(g1, g1)))
    assert make_cem(CEMConf(scale=4, kernel=k2), device="cpu")._mode == jmake_cem(JCEMConf(scale=4, kernel=k2))._mode
    assert make_cem(CEMConf(scale=4, kernel=k2, inv_mode=mode), device="cpu")._mode == mode


def test_separable_custom_kernel_matches_jax():
    """A provided 1-D kernel takes the matmul mode in both packages."""
    k = (1.0, 4.0, 6.0, 4.0, 1.0, 0.5, 0.25, 0.1)
    cem = make_cem(CEMConf(scale=4, kernel=k), device="cpu")
    jcem = jmake_cem(JCEMConf(scale=4, kernel=k))
    rng = np.random.default_rng(9)
    hr = rng.random((1, 40, 32, 2)).astype(np.float32)
    lr = rng.random((1, 10, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(
        cem.project(_t(hr), _t(lr)).numpy(),
        np.asarray(jcem.project(jnp.asarray(hr), jnp.asarray(lr))),
        atol=ATOL,
    )
