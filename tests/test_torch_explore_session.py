"""The port's exploration session and CLI against esr_tpu.explore.

Both sessions run the small generator of tests/test_torch_explore_helpers.py
(f32, CEM, LR 16 x 16) on the same weights. Each tool click: the loss trace
at rtol 1e-4; Z at atol 1e-4, except on elements whose JAX gradient at the
search's start is below 1e-6 of its largest (Adam turns such a float-noise
gradient into a full-LR step whose sign is noise: PERF.md, Findings);
and the port session's SR equal to the JAX forward of the port's Z at atol
1e-5. Searches are 2-3 steps a round: later, where a Z element's
gradient changes sign, Adam's ratio of nearly cancelled moments lets f32
rounding part the two trajectories (measured: 4 steps move a few such
elements by ~1e-3 while the losses still agree to 1e-6). Also: the polygon
and mask selections, undo / redo / reset, the alternatives' starts
(``np.random.default_rng(seed)`` in both),
realism and ``d_score`` through the same discriminator, ``save_state`` /
``load_state``, the weights swap, the deliberate divergence of
``match_histogram`` (it takes the session's ``zmax``), and the CLI: every
command of its docstring, ``build_session_from_opt`` from ``.pth`` files,
``infer_d_nf``, ``--estimate_kernel`` and ``main`` on a piped script.
"""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.explore import z_optimizer as JZ
from esr_tpu.explore.session import ExplorationSession as JSession
from esr_tpu.models.architecture import DiscriminatorVGG128 as JD
from esr_tpu_torch.data.util import save_img
from esr_tpu_torch.explore import cli
from esr_tpu_torch.explore.session import ExplorationSession
from esr_tpu_torch.models import define_D
from esr_tpu_torch.models.architecture import DiscriminatorVGG128
from esr_tpu_torch.models.networks import discriminator_state_dict_from_jax
from test_torch_explore_helpers import OPT, Setup, z_close

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
SR_ATOL = 1e-5
RECT = (12, 8, 44, 36)  # HR rectangle: LR box (3, 2, 11, 9), a 16 x 16 bucket


@pytest.fixture(scope="module")
def setup():
    return Setup()


@pytest.fixture(scope="module")
def discriminator():
    """A JAX DiscriminatorVGG128 (nf 4, trained input 128, non-trivial
    running statistics) and the port's on the same weights."""
    jd = JD(in_nc=3, nf=4, norm="batch")
    variables = jd.init(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 3)), train=False)
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
                                   variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    d = DiscriminatorVGG128(in_nc=3, nf=4, norm="batch", hr_size=(128, 128))
    d.load_state_dict(discriminator_state_dict_from_jax(variables, hr_size=128), strict=True)
    return variables, d


class _Searches:
    """Wraps the JAX session's Z optimizer and keeps each search's start:
    (the objective cropped to the bucket, LR, Z and mask crops)."""

    def __init__(self, inner, setup):
        self.inner, self.setup, self.starts = inner, setup, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, lr, z, objective, mask_hr=None, box_lr=None, **kw):
        n, h, w, _ = np.shape(lr)
        y, x, size = JZ.bucket_crop(box_lr, h, w, 4) if box_lr is not None else (0, 0, h)
        c = np.s_[:, y : y + size, x : x + size]
        self.starts.append((objective.crop_hr(4 * y, 4 * x, 4 * size) if box_lr is not None else objective,
                            np.asarray(lr)[c], np.asarray(z)[c], np.asarray(mask_hr)[4 * y : 4 * (y + size),
                                                                                    4 * x : 4 * (x + size)], c))
        return self.inner(lr, z, objective, mask_hr=mask_hr, box_lr=box_lr, **kw)

    def grad0(self, i=-1):
        """JAX's gradient at search ``i``'s start, and its crop."""
        obj, lr, z, mask, c = self.starts[i]
        fwd, params = self.setup.jforward, self.setup.params
        g = jax.grad(lambda zz: obj.fn(fwd(params, jnp.asarray(lr), zz), jnp.asarray(mask), obj.aux or {}))(
            jnp.asarray(z))
        return np.asarray(g), c


def _sessions(setup, n_steps=3):
    js = JSession(setup.jforward, setup.params, setup.lr, n_steps=n_steps)
    js._optimizer = _Searches(js._optimizer, setup)
    ps = ExplorationSession(setup.g(), setup.cem, setup.lr, n_steps=n_steps)
    return js, ps


def _same_z(zp, zj, js, i=-1):
    """Z as JAX's inside the searched crop (float-noise elements excepted) and
    equal outside it."""
    g0, c = js._optimizer.grad0(i)
    z_close(zp[c], zj[c], g0)
    outside = np.ones(zp.shape, bool)
    outside[c] = False
    np.testing.assert_array_equal(zp[outside], zj[outside])


def _same_click(js, ps, losses_j, losses_p):
    """The same loss trace and Z; the port's SR is the JAX forward of its Z."""
    np.testing.assert_allclose(np.asarray(losses_p), np.asarray(losses_j), rtol=LOSS_RTOL)
    assert ps.z.shape == js.z.shape and ps.z.dtype == np.float32
    _same_z(ps.z, js.z, js)
    np.testing.assert_allclose(ps.current_sr(), js.current_sr(ps.z), atol=SR_ATOL, rtol=0)


def _target(session, seed):
    """An imprint target above the SR everywhere by 0.2-0.4: the L1's sign
    holds through the search. (Where it flips, float noise picks the side and
    the searches part ways, as the JAX package's own do between machines.)"""
    rng = np.random.default_rng(seed)
    return session.current_sr()[0] + rng.uniform(0.2, 0.4, (64, 64, 3)).astype(np.float32)


TOOLS = {
    "variance +": lambda s, t: s.increase_variance(),
    "variance -": lambda s, t: s.decrease_variance(),
    "brightness": lambda s, t: s.brightness(0.8),
    "smooth": lambda s, t: s.smooth(),
    "periodicity": lambda s, t: s.periodicity(0.0, 3.0),
    "imprint": lambda s, t: s.imprint(t, adaptive=False),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_click_matches_jax(setup, tool):
    """One click of each tool on a rectangle selection: the same loss trace
    and SR as the JAX session; the edit stays inside the crop, and the SR
    stays CEM-consistent."""
    js, ps = _sessions(setup)
    target = _target(ps, 1)
    for s in (js, ps):
        s.select_rect(*RECT)
    lj, lp = TOOLS[tool](js, target), TOOLS[tool](ps, target)
    _same_click(js, ps, lj, lp)
    assert not ps.z[:, 16:].any() and not ps.z[:, :, 16:].any()  # pasted back into the 16 x 16 crop only
    sr = torch.from_numpy(ps.current_sr())
    assert (setup.cem.downsample(sr) - torch.from_numpy(setup.lr)).abs().max() <= 1e-5


def test_adaptive_imprint_matches_jax(setup):
    """The editor's imprint (adaptive, with the session's z-range ceiling):
    the same rounds (LR, z-range, stop), trace and SR."""
    js, ps = _sessions(setup, n_steps=2)
    target = _target(ps, 2)
    for s in (js, ps):
        s.select_rect(*RECT)
    lj, lp = js.imprint(target), ps.imprint(target)
    _same_click(js, ps, lj, lp)
    assert len(ps.last_rounds) == len(js.last_rounds)
    for a, b in zip(ps.last_rounds, js.last_rounds):
        assert (a["lr"], a["z_range"], a.get("stop")) == pytest.approx((b["lr"], b["z_range"], b.get("stop")))


def test_match_histogram_matches_jax(setup):
    """The histogram tool's search (fixed LR) is the reference's; where the
    two packages' tools differ is only the Z-box ceiling of the adaptive
    search (the next test)."""
    js, ps = _sessions(setup)
    patch = np.random.default_rng(3).random((9, 7, 3)).astype(np.float32) ** 2
    for s in (js, ps):
        s.select_rect(*RECT)
    _same_click(js, ps, js.match_histogram(patch, adaptive=False), ps.match_histogram(patch, adaptive=False))


def test_match_histogram_takes_the_session_zmax(setup):
    """A deliberate divergence: the reference's ``match_histogram`` never
    widens the Z box whatever ``zmax`` says; the port's takes the session's
    ceiling, as ``imprint`` does (and ``zmax 0`` keeps it in the box)."""
    js, ps = _sessions(setup, n_steps=1)
    seen = {"jax": [], "port": []}
    for name, s in (("jax", js), ("port", ps)):
        inner = s._optimizer

        def spy(*a, _inner=inner, _seen=seen[name], **kw):
            _seen.append(kw.get("z_range_max"))
            return _inner(*a, **kw)

        s._optimizer = spy
        s._optimizer.last_rounds = None
    patch = np.full((4, 4, 3), 0.5, np.float32)
    for s in (js, ps):
        s.match_histogram(patch, adaptive=False)
        s.set_search_strength(z_range_max=2.0)
        s.match_histogram(patch, adaptive=False)
        s.set_search_strength(z_range_max=0)
        s.match_histogram(patch, adaptive=False)
    assert seen["jax"] == [None, None, None]
    assert seen["port"] == [3.0, 2.0, None]


def test_polygon_and_mask_selection_match_jax(setup):
    js, ps = _sessions(setup)
    for verts in ([(4, 4), (4, 50), (40, 30)], [(10.5, 3), (60, 20), (30, 60), (2, 40), (20, 20)]):
        js.select_polygon(verts)
        ps.select_polygon(verts)
        np.testing.assert_array_equal(ps._mask, js._mask)
        assert ps._box_lr == js._box_lr
    brush = np.zeros((64, 64), bool)
    brush[20:23, 5:9] = True
    js.select_mask(brush)
    ps.select_mask(brush)
    assert ps._box_lr == js._box_lr == (5, 1, 6, 3)
    with pytest.raises(ValueError, match="HR shape"):
        ps.select_mask(np.ones((10, 10)))
    ps.select_mask(np.zeros((64, 64)))
    assert ps._box_lr is None


def test_history_undo_redo_reset(setup):
    """Undo / redo walk the Z history (the SR follows, recomputed bit for bit);
    a new edit clears the redo stack; reset zeroes Z in the region only; the
    history keeps at most ``history_limit`` states."""
    ps = ExplorationSession(setup.g(), setup.cem, setup.lr, n_steps=2, history_limit=2)
    sr0 = ps.current_sr().copy()
    ps.select_rect(*RECT)
    ps.brightness(0.9)
    z1, sr1 = ps.z.copy(), ps.current_sr().copy()
    assert z1.any()
    ps.undo()
    assert not ps.z.any() and np.array_equal(ps.current_sr(), sr0)
    ps.redo()
    assert np.array_equal(ps.z, z1) and np.array_equal(ps.current_sr(), sr1)
    ps.select_rect(0, 0, 64, 64)
    ps.z[:] = 0.5
    ps.select_rect(0, 0, 32, 32)
    ps.reset_region_z()
    assert not ps.z[:, :8, :8].any() and (ps.z[:, 8:] == 0.5).all()
    ps.undo()
    assert (ps.z == 0.5).all()
    ps.redo()
    ps.smooth()
    ps.redo()  # the edit cleared the redo stack: nothing to redo
    for _ in range(5):
        ps.undo()
    assert len(ps._history) == 0 and len(ps._redo) == 2  # only two states were kept


def test_alternatives_match_jax(setup):
    """``propose_alternatives``: the same random starts in both packages, so
    the same candidates; nothing is committed; ``apply_alternative`` is one
    undo step; ``random_alternatives`` commits each in turn."""
    js, ps = _sessions(setup, n_steps=3)
    for s in (js, ps):
        s.select_rect(*RECT)
    seen = []
    cj = js.propose_alternatives(k=2, seed=4)
    cp = ps.propose_alternatives(k=2, seed=4, candidate_cb=lambda i, k: seen.append((i, k)))
    assert seen == [(1, 2), (2, 2)] and not ps.z.any()
    for i, ((zj, _), (zp, srp)) in enumerate(zip(cj, cp)):
        _same_z(zp, zj, js, i)
        np.testing.assert_allclose(srp, js.current_sr(zp), atol=SR_ATOL, rtol=0)
        assert not zp[:, 16:].any() and not zp[:, :, 16:].any()
    assert np.abs(cp[0][1] - cp[1][1]).max() > 1e-4
    ps.apply_alternative(cp[1][0])
    assert np.array_equal(ps.z, cp[1][0])
    ps.undo()
    assert not ps.z.any()
    with pytest.raises(ValueError, match="shape"):
        ps.apply_alternative(np.zeros((1, 3, 3, 1), np.float32))
    srs = ps.random_alternatives(k=2, seed=4)
    np.testing.assert_allclose(srs[1], cp[1][1], atol=SR_ATOL, rtol=0)
    ps.undo()
    assert np.array_equal(ps.z, cp[0][0])


def test_realism_and_d_score_match_jax(setup, discriminator):
    """The realism tool and the region's D score through the same
    discriminator (the crop, 64 HR pixels, resized to D's 128)."""
    variables, d = discriminator
    js, ps = _sessions(setup, n_steps=3)
    with pytest.raises(ValueError, match="discriminator"):
        ps.realism()
    js.set_discriminator(variables, nf=4, norm="batch")
    ps.set_discriminator(d)
    for s in (js, ps):
        s.select_rect(*RECT)
    np.testing.assert_allclose(ps.d_score(), js.d_score(), rtol=LOSS_RTOL)
    _same_click(js, ps, js.realism(1.0), ps.realism(1.0))
    np.testing.assert_allclose(ps.d_score(), js.d_score(), rtol=LOSS_RTOL)
    assert not any(p.requires_grad for p in d.parameters())


def test_save_load_state_and_weight_swap(setup, tmp_path):
    """``save_state`` / ``load_state`` round-trip Z, LR and the selection and
    clear the history; ``set_generator_weights`` loads new weights and the SR
    follows them."""
    ps = ExplorationSession(setup.g(), setup.cem, setup.lr, n_steps=2)
    ps.select_rect(*RECT)
    ps.smooth()
    z, mask = ps.z.copy(), ps._mask.copy()
    path = str(tmp_path / "s.npz")
    ps.save_state(path)
    ps.undo()
    ps.select_rect(0, 0, 4, 4)
    ps.load_state(path)
    assert np.array_equal(ps.z, z) and np.array_equal(ps._mask, mask) and ps._box_lr == (3, 2, 11, 9)
    assert not ps._history and not ps._redo
    sr = ps.current_sr().copy()
    state = {k: v * 1.5 if k.endswith("weight") else v for k, v in setup.state.items()}
    ps.set_generator_weights(state)
    assert not np.allclose(ps.current_sr(), sr)
    assert not any(p.requires_grad for p in ps.g.parameters())
    ps.save_sr(str(tmp_path / "sr.png"))
    assert (tmp_path / "sr.png").stat().st_size > 0


# -- the CLI -------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_files(setup, discriminator, tmp_path_factory):
    """An eval options file for the small model, its G and D ``.pth``, an LR
    PNG, an imprint image and a histogram patch."""
    tmp = tmp_path_factory.mktemp("cli")
    torch.save(setup.state, tmp / "G.pth")
    torch.save(discriminator[1].state_dict(), tmp / "D.pth")
    save_img((setup.lr[0] * 255).round().astype(np.uint8), str(tmp / "lr.png"))
    save_img(np.full((10, 12, 3), 200, np.uint8), str(tmp / "patch.png"))
    opt = {"name": "explore", "model": "sr", "scale": 4, "use_cem": True, "bf16": False,
           "network_G": dict(OPT["network_G"]), "network_D": {"nf": 64},
           "path": {"root": str(tmp), "pretrain_model_G": str(tmp / "G.pth"), "pretrain_model_D": str(tmp / "D.pth")}}
    return tmp, opt


def test_build_session_from_opt(cli_files, setup):
    """The session of an options file on the CPU: G from its ``.pth``, CEM, and
    a D whose width (4, not the options' stale 64) and head size (128) come
    from its checkpoint; the SR is the port forward's on the same weights."""
    tmp, opt = cli_files
    sess = cli.build_session_from_opt(opt, str(tmp / "lr.png"), device="cpu")
    assert sess.device.type == "cpu" and sess.nz == 1 and sess.scale == 4 and sess.lr_img.shape == (1, 16, 16, 3)
    assert sess._d is not None and sess._d.conv0_0.weight.shape[0] == 4 and not sess._d.training
    lr = torch.from_numpy(sess.lr_img)
    want = setup.port_forward()(lr, torch.zeros(1, 16, 16, 1))
    np.testing.assert_allclose(sess.current_sr(), want.numpy(), atol=1e-6, rtol=0)
    assert np.isfinite(sess.d_score())
    # --estimate_kernel (blind SR) is ported: the LR 16 is below the estimator's least 48
    with pytest.raises(ValueError, match="too small"):
        cli.build_session_from_opt(opt, str(tmp / "lr.png"), estimate_kernel_iters=100, device="cpu")


def test_infer_d_nf():
    state = define_D({"network_D": {"nf": 8}, "datasets": {"train": {"HR_size": 64}}, "bf16": False},
                     device="cpu").state_dict()
    assert cli.infer_d_nf(state) == 8
    assert cli.infer_d_nf({}, 32) == 32 and cli.infer_d_nf(None) == 64


def test_every_cli_command(cli_files):
    """Every command of the CLI's docstring through ``run_command``, with
    usage instead of a traceback for malformed arguments."""
    tmp, opt = cli_files
    sess = cli.build_session_from_opt(opt, str(tmp / "lr.png"), device="cpu")
    sess.set_search_strength(n_steps=2)
    doc_commands = {ln.split()[0] for ln in cli.__doc__.split("Commands (one per line)::")[1].splitlines()
                    if ln.strip() and not ln.strip().startswith("#") and ln.startswith("    ") and ln[4] != " "}
    run = lambda line: cli.run_command(sess, line)  # noqa: E731
    script = [
        ("select 8 8 40 40", "selected rect"), ("polygon 8 8 8 40 40 40 40 8", "polygon"),
        ("variance +", "variance +"), ("variance -", "variance -"), ("realism +", "realism +"),
        ("realism -", "realism -"), ("dscore", "D realism score"), ("brightness 0.6", "brightness"),
        ("smooth", "smooth"), ("periodicity 0 4", "periodicity"), (f"imprint {tmp / 'patch.png'}", "imprint"),
        ("text HI", "imprint 'HI'"), (f"histogram {tmp / 'patch.png'}", "histogram"),
        ("alternatives 2", "alternatives ready"), ("pick 1", "applied alternative 1"), ("steps 3", "steps set to 3"),
        ("zmax 2", "ceiling set to 2"), ("zmax 0", "disabled"), ("undo", "undone"), ("redo", "redone"),
        ("reset", "region Z reset"), (f"zmap {tmp / 'z.png'}", "z-map saved"), (f"save {tmp / 'sr.png'}", "saved"),
        (f"savez {tmp / 's.npz'}", "state saved"), (f"loadz {tmp / 's.npz'}", "loaded"), ("clear", "cleared"),
    ]
    ran = set()
    for line, want in script:
        msg = run(line)
        assert want in msg, (line, msg)
        ran.add(line.split()[0])
    assert ran | {"quit", "undo", "redo", "reset"} >= doc_commands - {"undo"}, doc_commands - ran
    assert (tmp / "z.png").exists() and (tmp / "sr.png").exists()
    assert run("quit") == "" and run("   ") == "noop"
    assert run("frobnicate") == "unknown command: frobnicate"
    for bad in ("polygon 1 2 3", "pick 7", "variance", "realism up", "brightness", "text", "imprint /no/such.png"):
        assert "bad arguments" in run(bad), bad


def test_cli_main_reads_commands_from_stdin(cli_files, monkeypatch, capsys):
    tmp, opt = cli_files
    import json

    path = tmp / "opt.json"
    path.write_text(json.dumps(opt))
    monkeypatch.setattr(sys, "stdin", io.StringIO("select 0 0 32 32\nsteps 2\nsmooth\nquit\nsmooth\n"))
    cli.main(["-opt", str(path), "--lr", str(tmp / "lr.png"), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("explorable-SR editor") and out[1].startswith("selected rect")
    assert out[3].startswith("smooth: loss") and len(out) == 4  # nothing after quit
