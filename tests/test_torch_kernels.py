"""The port's kernel modules (esr_tpu_torch.ops.cuda) against the JAX package.

On the CPU each wrapper takes its plain PyTorch version, so these tests hold
that version (and the wrapper's dispatch and layouts) against the flax block,
the Pallas kernel in interpret mode and ``lax.conv``. f32 throughout, inputs
from numpy seeds. The CUDA kernels themselves are held against the same
plain versions on the card by tests/test_torch_cuda.py and
tests/test_torch_card_*.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.models.blocks import ResidualDenseBlock5C
from esr_tpu.ops.fused import upsample2x_conv3x3 as jax_upsample2x_conv3x3
from esr_tpu.ops.pallas.rdb_conv import fused_rdb5c_tiled as jax_fused_rdb5c_tiled
from esr_tpu.ops.pallas.rdb_conv import rdb5c_params_from_flax
from esr_tpu_torch.models.blocks import upsample_nearest
from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv
from esr_tpu_torch.ops.fused import upsample2x_conv3x3

torch.set_num_threads(1)

RDB_ATOL = 2e-4  # the Pallas tests' tolerance for the same block (tests/test_pallas.py)
CONV_ATOL = 1e-5  # one conv: K <= 9 * Cin terms in another summation order


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rdb_case(packed: bool, seed: int = 2):
    nf, gc = 8, 4
    block = ResidualDenseBlock5C(nf=nf, gc=gc, packed=packed)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((2, 16, 20, nf)), jnp.float32)
    variables = block.init(jax.random.PRNGKey(0), x)
    kp = rdb5c_params_from_flax(variables["params"])
    return block, variables, x, kp


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "concat"])
def test_rdb5c_matches_flax_block(packed):
    """rdb5c_reference and both wrappers (CPU dispatch) equal the flax block."""
    block, variables, x, kp = _rdb_case(packed)
    ref = np.asarray(block.apply(variables, x))
    tp = {k: _t(v) for k, v in kp.items()}
    tx = _t(x)
    for got in (
        rdb_conv.rdb5c_reference(tx, tp),
        rdb_conv.fused_rdb5c(tx, tp),
        rdb_conv.fused_rdb5c_tiled(tx, tp, strip=6, wtile=6),
    ):
        np.testing.assert_allclose(got.numpy(), ref, atol=RDB_ATOL)


def test_rdb5c_matches_pallas_interpret():
    """The port's fused_rdb5c_tiled vs the Pallas kernel in interpret mode on a
    3x4 grid of 6x6 tiles with ragged edges."""
    _, _, x, kp = _rdb_case(True)
    ref = np.asarray(jax_fused_rdb5c_tiled(x, kp, interpret=True, strip=6, wtile=6))
    got = rdb_conv.fused_rdb5c_tiled(_t(x), {k: _t(v) for k, v in kp.items()}, strip=6, wtile=6)
    np.testing.assert_allclose(got.numpy(), ref, atol=RDB_ATOL)


@pytest.mark.parametrize(
    "shape,cout", [((2, 16, 16, 8), 12), ((1, 11, 13, 4), 64), ((2, 9, 7, 16), 3)]
)
def test_conv3x3_matches_lax_conv(shape, cout):
    """conv3x3_reference / kpack_conv3x3 (CPU) equal lax.conv SAME, the
    function kpack_conv3x3 computes, incl. conv_first's Cin 4 and conv_last's Cout 3."""
    rng = np.random.default_rng(sum(shape) + cout)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, shape[-1], cout))).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    for fn in (kpack_conv.conv3x3_reference, kpack_conv.kpack_conv3x3):
        np.testing.assert_allclose(fn(_t(x), _t(w)).numpy(), ref, atol=CONV_ATOL)


def test_conv3x3_bias_lrelu_epilogue():
    """The fused epilogue is bias, then lrelu_0.2."""
    rng = np.random.default_rng(5)
    x, w, b = _t(rng.standard_normal((1, 6, 5, 4))), _t(rng.standard_normal((3, 3, 4, 8))), _t(rng.standard_normal(8))
    plain = kpack_conv.conv3x3_reference(x, w)
    got = kpack_conv.kpack_conv3x3(x, w, b, act=True)
    np.testing.assert_allclose(got.numpy(), torch.nn.functional.leaky_relu(plain + b, 0.2).numpy(), atol=CONV_ATOL)


@pytest.mark.parametrize("act", [False, True])
def test_upsample2x_conv3x3_matches_jax(act):
    """The port's 4-parity rewrite equals esr_tpu.ops.fused.upsample2x_conv3x3
    and conv3x3(nearest_2x(x))."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, 9, 8)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 8, 6))).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = np.asarray(jax_upsample2x_conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    if act:
        ref = np.where(ref >= 0, ref, 0.2 * ref)
    got = upsample2x_conv3x3(_t(x), _t(w), _t(b), act=act)
    assert tuple(got.shape) == (2, 14, 18, 6)
    np.testing.assert_allclose(got.numpy(), ref, atol=CONV_ATOL)
    direct = kpack_conv.conv3x3_reference(upsample_nearest(_t(x), 2), _t(w), _t(b), act)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=CONV_ATOL)


def test_wrappers_refuse_devices_without_a_kernel():
    """No silent fallback: a tensor on neither the CPU nor CUDA raises."""
    x = torch.empty((1, 4, 4, 8), device="meta")
    w = torch.empty((3, 3, 8, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        kpack_conv.kpack_conv3x3(x, w)
    with pytest.raises(RuntimeError, match="no kernel"):
        upsample2x_conv3x3(x, w)
    with pytest.raises(RuntimeError, match="no kernel"):
        rdb_conv.fused_rdb5c(x, {"w1": w})

