"""The port's parallel axes (esr_tpu_torch/parallel/) against the JAX
package's (esr_tpu/parallel/), case by case as tests/test_parallel.py runs
them: the same weights and the same inputs (numpy, seeded) through both. JAX shards over the 8 virtual
CPU devices of tests/conftest.py; the port runs 2 or 4 ranks of a gloo
process group on the CPU (``comm.spawn``, tests/torch_parallel_workers.py),
each multi-process run bounded by its own timeout. Weights: see ``jax_model``.

Tolerance: f32, 1e-5 of the reference's largest magnitude, or JAX's own
bound where its test states one (2e-4 relative for the window forward's
gradients, 2e-4 absolute against the whole image). Gradients are of a
linear loss, mean(out * cot), so that no |.| flips sign on float noise; the
sharded paths' are held to the sequential forward's (JAX's, by the same
weights), which is how tests/test_parallel.py holds JAX's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from esr_tpu.cem import CEMConf, make_cem as jmake_cem
from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu.models.networks import load_rrdb_from_torch
from esr_tpu.parallel import make_mesh as jmake_mesh
from esr_tpu.parallel import make_spatial_tp_mesh as jmake_spatial_tp_mesh
from esr_tpu.parallel import make_stage_mesh as jmake_stage_mesh
from esr_tpu.parallel import make_tp_mesh as jmake_tp_mesh
from esr_tpu.parallel import pipelined_rrdb_apply as jpipelined
from esr_tpu.parallel import spatial_fold_apply as jspatial_fold_apply
from esr_tpu.parallel import spatial_sharded_forward as jring
from esr_tpu.parallel import spatial_tp_apply as jspatial_tp
from esr_tpu.parallel import spatial_window_forward as jwindow
from esr_tpu.parallel import tiled_forward as jtiled
from esr_tpu.parallel import tp_rrdb_apply as jtp
from esr_tpu.parallel.pipeline import derive_n_micro as jderive_n_micro
from esr_tpu_torch.cem import make_cem
from esr_tpu_torch.models import state_dict_from_jax
from esr_tpu_torch.models.architecture import RRDBNet
from esr_tpu_torch.parallel import comm, make_mesh, make_spatial_tp_mesh, make_stage_mesh, make_tp_mesh
from esr_tpu_torch.parallel import spatial_fold_apply, spatial_window_forward, tiled_forward
from esr_tpu_torch.parallel.dp import _check_divisible
from esr_tpu_torch.parallel.pipeline import derive_n_micro

TIMEOUT = 120.0


def rng_arrays(seed: int, *shapes, signed=()):
    r = np.random.default_rng(seed)
    return [(r.uniform(-1, 1, s) if i in signed else r.random(s)).astype(np.float32) for i, s in enumerate(shapes)]


@functools.lru_cache(maxsize=None)
def jax_model(seed: int, nb: int, nz: int = 1, nf: int = 8, gc: int = 4, latent: str = "first_layer"):
    """A JAX RRDBNet and its variables, and the port's (cfg, state) of the
    same weights: the port's seeded ones carried to JAX by
    ``load_rrdb_from_torch``, or, for ``all_layers`` (which that bridge does
    not carry), JAX's init carried to the port by ``state_dict_from_jax``."""
    m = JRRDBNet(nf=nf, nb=nb, gc=gc, scale=4, num_latent_channels=nz, latent_input=latent)
    cfg = dict(nf=nf, nb=nb, gc=gc, scale=4, num_latent_channels=nz, latent_input=latent)
    if latent == "all_layers":
        v = jax.jit(m.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, nz)))
        state = {k: v_.numpy() for k, v_ in state_dict_from_jax(jax.device_get(v["params"])).items()}
    else:
        state = {k: v_.numpy() for k, v_ in RRDBNet(**cfg, seed=seed).state_dict().items()}
        v = load_rrdb_from_torch(state, nb=nb)
    return m, v, (cfg, state)


def jgrads(apply, v, lr, z, cot) -> tuple[np.ndarray, dict]:
    """JAX's output and the gradients of mean(apply * cot) (params by the
    port's names, and z)."""
    def loss(vv, zz):
        return jnp.mean(apply(vv, lr, zz) * cot)

    gv, gz = jax.jit(jax.grad(loss, argnums=(0, 1)))(v, z)
    out = {k: x.numpy() for k, x in state_dict_from_jax(jax.device_get(gv["params"])).items()}
    out["Z"] = np.asarray(gz)
    return np.asarray(jax.jit(apply)(v, lr, z)), out


def close(a, b, rel: float = 1e-5, atol: float = 0.0) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= rel * max(float(np.abs(b).max()), 1e-30) + atol, (err, float(np.abs(b).max()))


def close_grads(got: dict, want: dict, rel: float = 1e-5, atol: float = 0.0) -> None:
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        try:
            close(got[k], want[k], rel, atol)
        except AssertionError as e:
            raise AssertionError(f"{k}: {e}") from None


@pytest.fixture(scope="module")
def refs():
    """The JAX side of every multi-rank case, and the ranks' payloads."""
    out, pay = {}, {}
    # the ring, with and without Z (tests/test_parallel.py: spatial_sharded_forward)
    m, v, mc = jax_model(0, nb=1)
    lr, z = rng_arrays(7, (1, 32, 16, 3), (1, 32, 16, 1), signed=(1,))
    fwd = jring(lambda p, a, b=None: m.apply({"params": p}, a, b), jmake_mesh(2, spatial=2), scale=4, halo=8)
    out["ring"] = np.asarray(jax.jit(lambda p, a: fwd(p, a))(v["params"], lr))
    out["ring_z"] = np.asarray(jax.jit(fwd)(v["params"], lr, z))
    pay["ring"] = {"model": mc, "lr": lr, "z": z}
    # exact-edge windows
    m, v, mc = jax_model(0, nb=4)
    lr, z = rng_arrays(7, (1, 64, 16, 3), (1, 64, 16, 1), signed=(1,))
    fwd = jwindow(lambda p, a, b=None: m.apply({"params": p}, a, b), jmake_mesh(2, spatial=2), scale=4, halo=8)
    out["window"] = np.asarray(jax.jit(fwd)(v["params"], lr, z))
    out["window_full"] = np.asarray(jax.jit(m.apply)(v, lr, z))
    pay["window"] = {"model": mc, "lr": lr, "z": z}
    m, v, mc = jax_model(0, nb=1)
    lr, z, tgt = rng_arrays(3, (2, 80, 12, 3), (2, 80, 12, 1), (2, 320, 48, 3), signed=(1,))
    out["window_grad_full"] = jgrads(lambda vv, a, b: m.apply(vv, a, b), v, lr, z, tgt)
    pay["window_grad"] = {"model": mc, "lr": lr, "z": z, "tgt": tgt}
    # channel TP
    m, v, mc = jax_model(0, nb=4)
    lr, z, tgt = rng_arrays(0, (2, 8, 8, 3), (2, 8, 8, 1), (2, 32, 32, 3), signed=(1,))
    tp = jax.jit(jtp(m, jmake_tp_mesh(2)))
    out["tp"] = np.asarray(tp(v, lr, z))
    out["tp_seq"] = jgrads(m.apply, v, lr, z, tgt)
    out["tp_none"] = np.asarray(tp(v, lr, None))
    ma, va, mca = jax_model(1, nb=4, nz=2, latent="all_layers")
    (z_al,) = rng_arrays(1, (2, 8, 8, 2), signed=(0,))
    out["tp_al"] = np.asarray(jax.jit(jtp(ma, jmake_tp_mesh(2)))(va, lr, z_al))
    out["tp_al_seq"] = np.asarray(jax.jit(ma.apply)(va, lr, z_al))
    pay["tp"] = {"model": mc, "model_al": mca, "lr": lr, "z": z, "z_al": z_al, "tgt": tgt}
    # GPipe
    m, v, mc = jax_model(0, nb=4)
    lr, z, tgt = rng_arrays(0, (8, 8, 8, 3), (8, 8, 8, 1), (8, 32, 32, 3), signed=(1,))
    pp = jax.jit(jpipelined(m, jmake_stage_mesh(2), n_micro=4))
    out["pp"] = np.asarray(pp(v, lr, z))
    out["pp_seq"] = jgrads(m.apply, v, lr, z, tgt)
    out["pp_none"] = np.asarray(pp(v, lr, None))
    ma, va, mca = jax_model(1, nb=4, nz=2, latent="all_layers")
    (z_al,) = rng_arrays(1, (8, 8, 8, 2), signed=(0,))
    out["pp_al"] = np.asarray(jax.jit(jpipelined(ma, jmake_stage_mesh(2), n_micro=4))(va, lr, z_al))
    pay["pp"] = {"model": mc, "model_al": mca, "lr": lr, "z": z, "z_al": z_al, "tgt": tgt}
    # one spatial shard x TP, spatial x TP, DP x TP
    m, v, mc = jax_model(0, nb=1)
    lr, z = rng_arrays(3, (1, 8, 16, 3), (1, 8, 16, 1), signed=(1,))
    out["single"] = np.asarray(jax.jit(m.apply)(v, lr, z))
    pay["single"] = {"model": mc, "lr": lr, "z": z}
    m, v, mc = jax_model(0, nb=4)
    lr, z = rng_arrays(7, (1, 64, 16, 3), (1, 64, 16, 1), signed=(1,))
    fwd = jax.jit(jspatial_tp(m, jmake_spatial_tp_mesh(2, 2), halo=8))
    out["spatial_tp"], out["spatial_tp_none"] = np.asarray(fwd(v, lr, z)), np.asarray(fwd(v, lr))
    pay["spatial_tp"] = {"model": mc, "lr": lr, "z": z}
    m, v, mc = jax_model(2, nb=2)
    lr, z = rng_arrays(2, (4, 8, 8, 3), (4, 8, 8, 1), signed=(1,))
    out["tp_dp"] = np.asarray(jax.jit(jtp(m, jmake_tp_mesh(2, data=2)))(v, lr, z))
    pay["tp_dp"] = {"model": mc, "lr": lr, "z": z}
    return out, pay


@pytest.fixture(scope="module")
def two(refs, tmp_path_factory):
    return comm.spawn(W.functions_2, 2, tmp_path_factory.mktemp("ranks2"), args=(refs[1],), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def four(refs, tmp_path_factory):
    return comm.spawn(W.functions_4, 4, tmp_path_factory.mktemp("ranks4"), args=(refs[1],), timeout=TIMEOUT,
                      threads=1)


def test_mesh_shapes_and_validation():
    """One process is a world of one rank: a mesh of one, and a mesh asking
    for more raises naming the ranks, where JAX (8 devices) names devices."""
    assert make_mesh().shape == {"data": 1, "spatial": 1} == dict(jmake_mesh(1).shape)
    assert make_tp_mesh(1).shape == {"model": 1} and make_stage_mesh(1).shape == {"stage": 1}
    for fn in (lambda: make_mesh(2), lambda: make_tp_mesh(data=16), lambda: make_tp_mesh(4, data=4),
               lambda: make_stage_mesh(2)):
        with pytest.raises(ValueError, match="ranks"):
            fn()
    with pytest.raises(ValueError, match="spatial x model"):
        make_spatial_tp_mesh(4, 4)
    with pytest.raises(ValueError, match="devices"):
        jmake_tp_mesh(data=16)
    with pytest.raises(ValueError, match=r"data\(3\) x spatial\(1\) != devices\(1\)"):
        make_mesh(1, data=3)


def _port(mc):
    return W.build(*mc)


def test_tiled_forward_matches_jax():
    """Tiles stitched, one global CEM projection: the same numbers as JAX's,
    exact consistency, and a smaller error at a larger overlap."""
    m, v, mc = jax_model(0, nb=1, nz=0)
    g = _port(mc)
    (lr,) = rng_arrays(3, (1, 40, 56, 3))
    jcem, cem = jmake_cem(CEMConf(scale=4)), make_cem(CEMConf(scale=4), device="cpu")
    full = np.asarray(jcem.project(m.apply(v, lr), lr))
    errs = {}
    for overlap in (4, 12):
        want = np.asarray(jtiled(lambda p, a, b=None: m.apply({"params": p}, a), v["params"], lr, tile=32,
                                 overlap=overlap, scale=4, cem=jcem))
        with torch.no_grad():
            got = tiled_forward(lambda a, b=None: g(a), torch.from_numpy(lr), tile=32, overlap=overlap, scale=4,
                                cem=cem).numpy()
        close(got, want)
        assert np.abs(np.asarray(cem.downsample(torch.from_numpy(got))) - lr).max() < 5e-5
        errs[overlap] = float(np.abs(got - full).mean())
    assert errs[12] < errs[4], errs
    with pytest.raises(ValueError, match="2\\*overlap"):
        tiled_forward(g, torch.from_numpy(lr), tile=8, overlap=4)


def test_tiled_forward_bf16_generator():
    _, _, mc = jax_model(0, nb=1, nz=0)
    g = _port(mc)
    (lr,) = rng_arrays(4, (1, 40, 40, 3))
    with torch.no_grad():
        out = tiled_forward(lambda a, b=None: g(a.bfloat16().float()).bfloat16(), torch.from_numpy(lr), tile=32,
                            overlap=4, scale=4)
    assert out.shape == (1, 160, 160, 3) and out.dtype == torch.float32 and torch.isfinite(out).all()


def test_spatial_fold_apply_matches_jax():
    """H strips batched on one device (JAX: the fold recovery): JAX's numbers,
    odd heights, pass-through of divisible batches and short images, z=None."""
    m, v, mc = jax_model(0, nb=2, nf=16, gc=8)
    g = _port(mc)
    x, z = rng_arrays(0, (1, 64, 48, 3), (1, 64, 48, 1), signed=(1,))
    jw = jspatial_fold_apply(jax.jit(lambda p, a, b: m.apply({"params": p}, a, b)), fold=2, halo=12, scale=4)
    pw = spatial_fold_apply(lambda a, b: g(a, b), fold=2, halo=12, scale=4)
    with torch.no_grad():
        for xx, zz in ((x, z), (x[:, :50], z[:, :50]), (np.concatenate([x, x]), np.concatenate([z, z])),
                       (x[:, :20], z[:, :20]), (x, None)):
            got = pw(torch.from_numpy(xx), None if zz is None else torch.from_numpy(zz)).numpy()
            close(got, np.asarray(jw(v["params"], xx, zz)))
            close(got, np.asarray(jax.jit(m.apply)(v, xx, zz)), rel=1e-4)


@pytest.mark.parametrize("batch", [1, 2, 4, 6, 8, 10, 16, 24, 32])
def test_derive_n_micro_matches_jax(batch):
    for stages in (1, 2, 4):
        for req in (None, 1, 3, 4, 8, 99):
            assert derive_n_micro(batch, stages, req) == jderive_n_micro(batch, stages, req), (batch, stages, req)


def test_spatial_sharded_forward_matches_jax(refs, two):
    """The ring (boundary slabs gathered, edges replicate-padded), with and
    without Z, on every rank: JAX's numbers, edges included."""
    out, _ = refs
    for r in two:
        close(r["ring"], out["ring"])
        close(r["ring_z"], out["ring_z"])


def test_spatial_window_forward_matches_jax(refs, two):
    out, _ = refs
    for r in two:
        close(r["window"], out["window"])
        close(r["window"], out["window_full"], rel=0, atol=2e-4)  # JAX's bound against the whole image


@pytest.mark.parametrize("ranks", ["2", "4"])
def test_spatial_window_forward_grads_match_jax(refs, two, four, ranks):
    """With a halo covering the receptive field, the output and the parameter
    and Z gradients of the window forward (2 spatial shards; 2 data x 2
    spatial) are the unsharded forward's (JAX's), as tests/test_parallel.py
    holds JAX's window forward to them (2e-4 relative)."""
    out, _ = refs
    full_out, full = out["window_grad_full"]
    for r in (two if ranks == "2" else four):
        got_out, got = r["window_grad"]
        close(got_out, full_out)
        close_grads(got, full, rel=2e-4)


def test_spatial_window_forward_single_shard_is_exact(refs, two):
    """One spatial shard: the halo drops to 0 and the window is the image, bit
    for bit; one shard x 2-way TP within TP's reduction-order noise."""
    out, pay = refs
    q = pay["single"]
    g = _port(q["model"])
    lr, z = torch.from_numpy(q["lr"]), torch.from_numpy(q["z"])
    with torch.no_grad():
        got = spatial_window_forward(g, make_mesh(1, spatial=1), scale=4, halo=2)(lr, z)
        np.testing.assert_array_equal(got.numpy(), g(lr, z).numpy())
    close(got.numpy(), out["single"])
    for r in two:
        close(r["single_tp"], out["single"])


def test_tp_rrdb_apply_matches_jax(refs, two):
    """Row-parallel trunk over 2 ranks: forward and z=None equal JAX's TP, and
    the parameter and Z gradients (gathered to full width) the sequential
    forward's, as JAX's TP gradients are held to them: no factor of T in any
    trunk gradient."""
    out, _ = refs
    seq_out, seq = out["tp_seq"]
    for r in two:
        got_out, got = r["tp"]
        close(got_out, out["tp"])
        close(got_out, seq_out)
        close(r["tp_none"], out["tp_none"])
        close_grads(got, seq)
        for k in ("RRDB_trunk.0.RDB1.conv1.weight", "RRDB_trunk.3.RDB3.conv5.weight"):
            ratio = np.linalg.norm(got[k]) / np.linalg.norm(seq[k])
            assert abs(ratio - 1) < 1e-4, (k, ratio)


def test_tp_all_layers(refs, two):
    """The all_layers 1x1 projections stay replicated; the rest shards."""
    out, _ = refs
    for r in two:
        close(r["tp_al"], out["tp_al"])
        close(r["tp_al"], out["tp_al_seq"])


def test_tp_trunk_kernels_are_sharded(refs, two):
    """Each rank holds half of every RDB conv kernel (and all the biases)."""
    _, pay = refs
    g = _port(pay["tp"]["model"])
    weights = sum(p.numel() * 4 for k, p in g.named_parameters() if k.startswith("RRDB") and k.endswith("weight"))
    biases = sum(p.numel() * 4 for k, p in g.named_parameters() if k.startswith("RRDB") and k.endswith("bias"))
    for r in two:
        assert r["tp_bytes"] == weights // 2 + biases, (r["tp_bytes"], weights, biases)


def test_pipelined_rrdb_apply_matches_jax(refs, two):
    """GPipe over 2 stages, 4 microbatches: forward and z=None equal JAX's
    pipeline and the sequential trunk, and the gradients of the reverse
    schedule the sequential forward's."""
    out, _ = refs
    seq_out, seq = out["pp_seq"]
    for r in two:
        got_out, got = r["pp"]
        close(got_out, out["pp"])
        close(got_out, seq_out)
        close(r["pp_none"], out["pp_none"])
        close_grads(got, seq)


def test_pipelined_all_layers(refs, two):
    out, _ = refs
    for r in two:
        close(r["pp_al"], out["pp_al"])


def test_spatial_tp_apply_matches_jax(refs, four):
    """Spatial x TP on 2 x 2 ranks: JAX's numbers, with and without Z."""
    out, _ = refs
    for r in four:
        close(r["spatial_tp"], out["spatial_tp"])
        close(r["spatial_tp_none"], out["spatial_tp_none"])


def test_clip_norm_spatial_tp(four):
    """Adam's global-norm clip under spatial x TP (the trainer's reductions,
    on the trunk's gradients): ``GradSync.sq_sum`` of a rank's reduced
    gradients is the norm of the gathered full-width gradients, the same on
    every rank; the rank's own slices alone fall short of it."""
    norms = [r["clip_norm"] for r in four]
    for n in norms:
        assert abs(n["sq_sum"] - n["full"]) <= 1e-5 * n["full"], n
        assert n["local"] < (1 - 1e-3) * n["full"], n
    assert len({n["sq_sum"] for n in norms}) == 1, norms


def test_tp_dp_composed_mesh(refs, four):
    """DP x TP on a (data 2, model 2) mesh: each data rank's rows, gathered."""
    out, _ = refs
    for r in four:
        close(r["tp_dp"], out["tp_dp"])


def test_parallel_validation_errors(two):
    """The divisibility, halo, width and mesh errors of the JAX package
    (tests/test_e2e.py::test_parallel_validation_errors and the validation
    cases of tests/test_parallel.py), raised by every rank."""
    with pytest.raises(ValueError, match="does not divide"):
        _check_divisible(np.zeros((6, 4, 4, 3)), 4)
    want = ["does not divide", "exceeds the local strip height", "exceeds the local strip height",
            "halo must be >= 1", "divisible by 2", "nb=3 not divisible by 2 stages", "divisible by 2",
            "data x model", "asked for 3 stages", "spatial x model"]
    for r in two:
        assert len(r["errors"]) == len(want)
        for msg, w in zip(r["errors"], want):
            assert w in msg, (w, msg)
