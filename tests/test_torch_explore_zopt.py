"""The port's Z optimizer against esr_tpu.explore.z_optimizer.

``bucket_crop``; ``optimize_z`` over 8 fixed steps through the small
generator of tests/test_torch_explore_helpers.py (f32, CEM), with and
without ``lr_decay``, chunked equal to one-shot; ``optimize_z_adaptive``
through an LR and a z-range escalation and with a best-not-last result;
``ZOptimizer``'s crop and paste-back. Loss traces at rtol 1e-4; Z at atol
1e-4, except on elements whose JAX gradient at the start is below 1e-6 of
its largest (Adam turns a float-noise gradient into a full-LR step: PERF.md,
Findings). Also the deliberate divergence: a boost of 1 or less is a ladder
of no rounds, where the JAX package divides by zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.explore import objectives as JO
from esr_tpu.explore import z_optimizer as JZ
from esr_tpu_torch.explore import objectives as PO
from esr_tpu_torch.explore import z_optimizer as PZ
from test_torch_explore_helpers import Setup, t, z_close

torch.set_num_threads(1)

LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    return Setup()


def test_bucket_crop_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(8, 300, 2))
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        box = (y0, x0, int(rng.integers(y0 + 1, h + 1)), int(rng.integers(x0 + 1, w + 1)))
        assert PZ.bucket_crop(box, h, w, 4) == JZ.bucket_crop(box, h, w, 4), (box, h, w)


def _start(setup):
    z0 = np.random.default_rng(1).uniform(-0.5, 0.5, (1, 16, 16, 1)).astype(np.float32)
    mask = np.zeros((64, 64), np.float32)
    mask[8:44, 12:60] = 1.0
    return z0, mask


def _jax_grad0(setup, objective, z0, mask):
    fn, aux = objective.fn, objective.aux or {}
    return jax.grad(lambda z: fn(setup.jforward(setup.params, jnp.asarray(setup.lr), z), jnp.asarray(mask), aux))(
        jnp.asarray(z0))


@pytest.mark.parametrize("lr_decay", [1.0, 0.3])
def test_optimize_z_fixed_steps(setup, lr_decay):
    """8 Adam steps on the variance objective: the same trace and Z (the LR
    decay exponential, not staircase, read before each update's count)."""
    z0, mask = _start(setup)
    kw = dict(n_steps=8, lr=0.1, z_range=1.0, lr_decay=lr_decay)
    jz, jl = JZ.optimize_z(setup.jforward, setup.params, jnp.asarray(setup.lr), jnp.asarray(z0), jnp.asarray(mask),
                           JO.variance_objective(1.0), **kw)
    pz, pl = PZ.optimize_z(setup.port_forward(), t(setup.lr), t(z0), t(mask), PO.variance_objective(1.0), **kw)
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=LOSS_RTOL)
    z_close(pz.numpy(), jz, _jax_grad0(setup, JO.variance_objective(1.0), z0, mask))
    assert float(pz.abs().max()) <= 1.0


def test_optimize_z_chunked_equals_one_shot(setup):
    """Chunks carry Z and the Adam state (and the LR schedule's count): the
    same steps as one chunk, with progress at each chunk's end."""
    z0, mask = _start(setup)
    forward = setup.port_forward()
    calls = []
    kw = dict(n_steps=7, lr=0.2, lr_decay=0.5)
    z1, l1 = PZ.optimize_z(forward, t(setup.lr), t(z0), t(mask), PO.brightness_objective(0.7), **kw)
    z3, l3 = PZ.optimize_z(forward, t(setup.lr), t(z0), t(mask), PO.brightness_objective(0.7), n_chunks=3,
                           progress_cb=lambda done, total, losses: calls.append((done, total, len(losses))), **kw)
    assert torch.equal(z1, z3) and np.array_equal(l1, l3)
    assert calls == [(2, 7, 2), (4, 7, 4), (7, 7, 7)]


def _toy_forward_jax(params, lr_img, z):
    return jnp.repeat(jnp.repeat(z * 1.0, 4, axis=1), 4, axis=2)


def _toy_forward_port(lr_img, z):
    return (z * 1.0).repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)


@pytest.mark.parametrize("case", ["lr-then-z-range", "best-not-last"])
def test_optimize_z_adaptive_matches_jax(case):
    """The adaptive search on a toy forward (Z upsampled): through the LR
    ladder then the z-range ladder towards a target outside the starting box,
    to the stop at full escalation; and an oscillating search whose best Z
    is not its last. Rounds (LR, z-range, first / last loss, stop reason),
    trace and best Z as JAX's."""
    if case == "lr-then-z-range":
        # the target lies outside even the widest box, so the loss stays far
        # from 0 (near 0, |mean - target| cancels and float noise dominates)
        target, kw = 2.5, dict(n_steps=25, lr=0.3, max_rounds=10, lr_boost=3.0, lr_max=0.9, z_range=1.0,
                               z_range_boost=2.0, z_range_max=2.0)
    else:
        target, kw = 0.35, dict(n_steps=10, lr=0.5, max_rounds=4, lr_boost=3.0, lr_max=4.5)
    z0 = np.zeros((1, 8, 8, 1), np.float32)
    mask = np.ones((32, 32), np.float32)
    jz, jl, jr = JZ.optimize_z_adaptive(_toy_forward_jax, None, jnp.zeros((1, 8, 8, 3)), jnp.asarray(z0),
                                        jnp.asarray(mask), lambda sr, m: jnp.abs(jnp.mean(sr) - target), **kw)
    pz, pl, pr = PZ.optimize_z_adaptive(_toy_forward_port, torch.zeros(1, 8, 8, 3), t(z0), t(mask),
                                        lambda sr, m: PO.jax_abs(torch.mean(sr) - target), **kw)
    assert len(pr) == len(jr) and pr[-1]["stop"] == jr[-1]["stop"]
    for a, b in zip(pr, jr):
        assert a["lr"] == pytest.approx(b["lr"]) and a["z_range"] == pytest.approx(b["z_range"])
        np.testing.assert_allclose([a["first"], a["last"], a["best"]], [b["first"], b["last"], b["best"]],
                                   rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), atol=1e-4)
    returned = float(PO.jax_abs(torch.mean(_toy_forward_port(None, pz)) - target))
    assert returned <= float(np.min(pl)) + 1e-6
    if case == "lr-then-z-range":
        assert any(r["z_range"] > 1.0 for r in pr) and float(pz.abs().max()) > 1.0
    else:
        assert returned < float(pl[-1])  # the best is not the last


def test_adaptive_boost_of_one_is_no_ladder():
    """A deliberate divergence: with ``max_rounds=None`` and a boost of 1, the
    JAX package divides by zero sizing the round budget; the port counts
    that ladder as no rounds and never climbs it."""
    z0 = np.zeros((1, 8, 8, 1), np.float32)
    mask = np.ones((32, 32), np.float32)

    def objective(sr, m):
        return torch.mean(sr) * 0.0 + 1.0  # flat: every round plateaus

    with pytest.raises(ZeroDivisionError):
        JZ.optimize_z_adaptive(_toy_forward_jax, None, jnp.zeros((1, 8, 8, 3)), jnp.asarray(z0), jnp.asarray(mask),
                               lambda sr, m: jnp.mean(sr) * 0.0 + 1.0, n_steps=2, lr=0.1, lr_boost=1.0)
    for kw, lrs, zrs in (
        (dict(lr_boost=1.0), [0.1], [1.0]),  # no ladder at all: stop after the first plateau
        (dict(lr_boost=1.0, z_range_max=4.0), [0.1, 0.1, 0.1, 0.1], [1.0, 1.75, 3.0625, 4.0]),
        (dict(z_range_boost=0.5, z_range_max=4.0, lr_max=0.3), [0.1, 0.3], [1.0, 1.0]),
    ):
        _, losses, rounds = PZ.optimize_z_adaptive(_toy_forward_port, torch.zeros(1, 8, 8, 3), t(z0), t(mask),
                                                   objective, n_steps=2, lr=0.1, **kw)
        assert [r["lr"] for r in rounds] == pytest.approx(lrs)
        assert [r["z_range"] for r in rounds] == pytest.approx(zrs)
        assert rounds[-1]["stop"] == "insensitive-at-max-escalation"
    assert PZ._ladder_rounds(0.1, 2.7, 1.0) == 0 and PZ._ladder_rounds(0.1, 2.7, 3.0) == 3


def test_zoptimizer_crops_and_pastes_back(setup):
    """A box in a corner of a 32 x 32 LR: the 16 x 16 bucket crop of LR, Z,
    mask and the imprint target is searched, its Z pasted back, the rest of
    Z untouched; trace and Z as JAX's ZOptimizer."""
    lr = np.random.default_rng(3).random((1, 32, 32, 3)).astype(np.float32)
    z0 = np.zeros((1, 32, 32, 1), np.float32)
    mask = np.zeros((128, 128), np.float32)
    mask[4:40, 8:36] = 1.0
    box = (1, 2, 10, 9)
    target = np.random.default_rng(4).random((128, 128, 3)).astype(np.float32)
    kw = dict(scale=4, n_steps=6, lr=0.1)
    jopt = JZ.ZOptimizer(setup.jforward, setup.params, **kw)
    jz, jl = jopt(lr, z0, JO.imprint_objective(jnp.asarray(target)), mask, box_lr=box)
    popt = PZ.ZOptimizer(setup.port_forward(), device="cpu", **kw)
    pz, pl = popt(lr, z0, PO.imprint_objective(target), mask, box_lr=box)
    y, x, size = PZ.bucket_crop(box, 32, 32, 4)
    assert (y, x, size) == (0, 0, 16)
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=LOSS_RTOL)
    assert not pz[:, 16:].any() and not pz[:, :, 16:].any() and pz.abs().max() > 0
    obj = JO.imprint_objective(jnp.asarray(target)).crop_hr(0, 0, 64)
    g0 = jax.grad(lambda z: obj.fn(setup.jforward(setup.params, jnp.asarray(lr[:, :16, :16]), z),
                                   jnp.asarray(mask[:64, :64]), obj.aux))(jnp.asarray(z0[:, :16, :16]))
    z_close(pz.numpy()[:, :16, :16], np.asarray(jz)[:, :16, :16], g0)
