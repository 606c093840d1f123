"""The port's CEM in its non-separable modes (``fft`` and ``filter``) against
the JAX package's, on the CPU.

A 2-D kernel (the anisotropic Gaussian of blind_bench, 13 x 13; the
MATLAB-bicubic kernel as a 2-D array, 16 x 16; a 9 x 9 Gaussian; a 2 x 3 box
smaller than the scale) goes through both packages on the same seeded
numpy inputs in f32. Tolerances: 1e-5 absolute for ``downsample``,
``upsample_transpose``, ``dt_satisfying_upscale`` and ``project`` on [0, 1]
data; ``apply_inv_hht`` amplifies (its output reaches ~65 on [0, 1] input),
so 1e-5 of its largest output (f32 rounding at that scale). The adjoint is
written out in the port, where JAX derives it by ``jax.linear_transpose``:
``<Hx, y> == <x, H^T y>`` to 1e-12 in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.cem import CEMConf as JCEMConf
from esr_tpu.cem import make_cem as jmake_cem
from esr_tpu.cem.kernels import downsample_kernel_2d
from esr_tpu.scripts.blind_bench import gaussian_kernel
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.cem.kernels import resolve_kernel

torch.set_num_threads(1)

ATOL = 1e-5
KERNELS = {
    "aniso_gauss": gaussian_kernel(),
    "bicubic_2d": downsample_kernel_2d(4)[0],
    "gauss_9": gaussian_kernel(sup=9, sx=1.5, sy=1.0, theta=0.3),
    "box_2x3": np.ones((2, 3)),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(kernel, **conf):
    kt = tuple(map(tuple, np.asarray(kernel, np.float64)))
    return make_cem(CEMConf(scale=4, kernel=kt, **conf), device="cpu"), jmake_cem(JCEMConf(scale=4, kernel=kt, **conf))


@pytest.mark.parametrize("mode", ["fft", "filter"])
@pytest.mark.parametrize("name", list(KERNELS))
def test_nonseparable_ops_match_jax(name, mode):
    """Every CEM op of the mode equals JAX's (non-square LR, batch 2, 3 ch)."""
    cem, jcem = _pair(KERNELS[name], inv_mode=mode)
    assert cem._mode == jcem._mode == mode
    rng = np.random.default_rng(0)
    hr = rng.random((2, 48, 40, 3)).astype(np.float32)
    lr = rng.random((2, 12, 10, 3)).astype(np.float32)
    jhr, jlr = jnp.asarray(hr), jnp.asarray(lr)
    np.testing.assert_allclose(cem.downsample(_t(hr)).numpy(), np.asarray(jcem.downsample(jhr)), atol=ATOL)
    np.testing.assert_allclose(cem.upsample_transpose(_t(lr), hr.shape).numpy(),
                               np.asarray(jcem.upsample_transpose(jlr, hr.shape)), atol=ATOL)
    want = np.asarray(jcem.apply_inv_hht(jlr))
    np.testing.assert_allclose(cem.apply_inv_hht(_t(lr)).numpy(), want, atol=ATOL * np.abs(want).max())
    np.testing.assert_allclose(cem.dt_satisfying_upscale(_t(lr)).numpy(),
                               np.asarray(jcem.dt_satisfying_upscale(jlr)), atol=ATOL)
    np.testing.assert_allclose(cem.project(_t(hr), _t(lr)).numpy(), np.asarray(jcem.project(jhr, jlr)), atol=ATOL)


@pytest.mark.parametrize("name", list(KERNELS))
def test_upsample_transpose_is_the_adjoint(name):
    """<Hx, y> == <x, H^T y> in f64 to 1e-12 (and in f32 to 1e-5 of the
    inner product), the port's H^T written out explicitly."""
    cem, _ = _pair(KERNELS[name])
    rng = np.random.default_rng(1)
    x = rng.random((2, 32, 36, 2))
    y = rng.random((2, 8, 9, 2))
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        xt, yt = _t(x).to(dt), _t(y).to(dt)
        a = float(torch.sum(cem.downsample(xt) * yt))
        b = float(torch.sum(xt * cem.upsample_transpose(yt, xt.shape)))
        assert abs(a - b) <= tol * max(1.0, abs(a)), (dt, a, b)


@pytest.mark.parametrize("name", ["aniso_gauss", "bicubic_2d"])
def test_fft_mode_is_consistent(name):
    """H(project(g, lr)) == lr and H(H^+ lr) == lr to 1e-5 under the 2-D
    kernel (fft mode: the exact inverse on the LR grid)."""
    cem, _ = _pair(KERNELS[name])
    rng = np.random.default_rng(2)
    lr = _t(rng.random((2, 12, 14, 3)).astype(np.float32))
    g = _t(rng.random((2, 48, 56, 3)).astype(np.float32) * 3 - 1)
    assert (cem.downsample(cem.project(g, lr)) - lr).abs().max().item() <= ATOL
    assert (cem.downsample(cem.dt_satisfying_upscale(lr)) - lr).abs().max().item() <= ATOL
    once = cem.project(g, lr)
    np.testing.assert_allclose(cem.project(once, lr).numpy(), once.numpy(), atol=ATOL)


def test_filter_mode_improves_with_support():
    """The truncated inverse filter: the consistency residual shrinks with
    the support and is below 2e-3 at 33 (tests/test_cem.py's band), as JAX's."""
    rng = np.random.default_rng(10)
    lr = rng.random((1, 16, 16, 3)).astype(np.float32)
    g = rng.random((1, 64, 64, 3)).astype(np.float32)
    res, jres = {}, {}
    for support in (13, 21, 33):
        cem = make_cem(CEMConf(scale=4, inv_mode="filter", inv_filter_support=support), device="cpu")
        jcem = jmake_cem(JCEMConf(scale=4, inv_mode="filter", inv_filter_support=support))
        np.testing.assert_allclose(cem.inv_hht_spatial_filter(), jcem.inv_hht_spatial_filter(), atol=1e-6)
        res[support] = (cem.downsample(cem.project(_t(g), _t(lr))) - _t(lr)).abs().max().item()
        jres[support] = float(np.abs(np.asarray(jcem.downsample(jcem.project(jnp.asarray(g), jnp.asarray(lr))))
                                     - lr).max())
        assert abs(res[support] - jres[support]) <= ATOL, (support, res, jres)
    assert res[33] < res[21] < res[13] and res[33] < 2e-3, res


def test_auto_mode_choice_matches_jax():
    """``auto`` picks fft for a 2-D kernel and matmul for a separable one,
    as JAX does; matmul with a 2-D kernel and an unknown mode raise."""
    for kernel, want in ((KERNELS["aniso_gauss"], "fft"), (None, "matmul"), ((1.0, 2.0, 1.0), "matmul")):
        kt = None if kernel is None else (tuple(map(tuple, kernel)) if np.ndim(kernel) == 2 else kernel)
        cem = make_cem(CEMConf(scale=4, kernel=kt), device="cpu")
        assert cem._mode == jmake_cem(JCEMConf(scale=4, kernel=kt))._mode == want
    with pytest.raises(ValueError, match="separable"):
        make_cem(CEMConf(scale=4, kernel=tuple(map(tuple, KERNELS["gauss_9"])), inv_mode="matmul"), device="cpu")
    with pytest.raises(ValueError, match="unknown inv_mode"):
        make_cem(CEMConf(scale=4, inv_mode="spline"), device="cpu")


def test_fft_mode_equals_matmul_mode_for_bicubic():
    """The bicubic kernel in fft mode == its separable matmul mode: H to
    1e-5, project and H^+ to 2e-4 (tests/test_cem.py's band), and H^T of
    the matmul mode is the adjoint of its H."""
    rng = np.random.default_rng(11)
    lr = _t(rng.random((2, 12, 12, 3)).astype(np.float32))
    g = _t(rng.random((2, 48, 48, 3)).astype(np.float32))
    cem_m = make_cem(CEMConf(scale=4), device="cpu")
    cem_f = make_cem(CEMConf(scale=4, inv_mode="fft"), device="cpu")
    assert (cem_m._mode, cem_f._mode) == ("matmul", "fft")
    np.testing.assert_allclose(cem_m.downsample(g).numpy(), cem_f.downsample(g).numpy(), atol=ATOL)
    np.testing.assert_allclose(cem_m.project(g, lr).numpy(), cem_f.project(g, lr).numpy(), atol=2e-4)
    np.testing.assert_allclose(cem_m.dt_satisfying_upscale(lr).numpy(), cem_f.dt_satisfying_upscale(lr).numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(cem_m.upsample_transpose(lr, g.shape).numpy(),
                               cem_f.upsample_transpose(lr, g.shape).numpy(), atol=ATOL)


def test_estimated_kernel_file_drives_cem(tmp_path):
    """A saved .npy estimate -> resolve_kernel -> CEM (fft mode) is exactly
    consistent under that kernel and equals JAX's projection."""
    path = str(tmp_path / "kernel_x4.npy")
    np.save(path, KERNELS["gauss_9"])
    cem, jcem = _pair(resolve_kernel(path))
    rng = np.random.default_rng(4)
    lr = rng.random((1, 12, 12, 3)).astype(np.float32)
    raw = rng.random((1, 48, 48, 3)).astype(np.float32)
    out = cem.project(_t(raw), _t(lr))
    assert cem._mode == "fft" and (cem.downsample(out) - _t(lr)).abs().max().item() <= ATOL
    np.testing.assert_allclose(out.numpy(), np.asarray(jcem.project(jnp.asarray(raw), jnp.asarray(lr))), atol=ATOL)


def test_inverse_frequencies_cached_per_lr_shape():
    """The fft mode builds the floored spectrum of H H^T once per LR shape."""
    cem, _ = _pair(KERNELS["aniso_gauss"])
    a = cem._q_freq(12, 10)
    assert cem._q_freq(12, 10) is a and cem._q_freq(10, 12) is not a
    assert a.dtype == torch.complex64 and tuple(a.shape) == (12, 10)
    assert float(a.abs().min()) >= cem.conf.eps * (1 - 1e-6)


@pytest.mark.parametrize("pad", [0, 2])
def test_wrap_with_a_2d_kernel_matches_jax(pad):
    """CEM.wrap around a generator under a 2-D kernel (fft mode), with and
    without ``pad_lr``: the same values as JAX's wrap."""
    cem, jcem = _pair(KERNELS["aniso_gauss"], pad_lr=pad)
    rng = np.random.default_rng(8)
    lr = rng.random((1, 12, 10, 3)).astype(np.float32)

    def fake_g(lr_, z_):
        return lr_.repeat_interleave(4, 1).repeat_interleave(4, 2) + 0.1

    def jfake_g(params, lr_, z_):
        return jnp.repeat(jnp.repeat(lr_, 4, axis=1), 4, axis=2) + 0.1

    out = cem.wrap(fake_g)(_t(lr))
    ref = jcem.wrap(jfake_g)(None, jnp.asarray(lr))
    assert tuple(out.shape) == tuple(ref.shape) == (1, 48, 40, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
