"""The editor at full width on the card: the session as the explore CLI
builds it (``build_session_from_opt``: G from the seed-0 ``.pth``, CEM, a
seed-0 D from its own ``.pth``) on an LR 128 x 128 PNG; a 40 x 40 LR
selection (bucket 64, crop 256 HR) and one click of each tool at 32 Z steps
a round (imprint adaptive, variance +/-, brightness, smooth, periodicity,
histogram, realism, alternatives k=2 with one applied), then smooth with no
selection: each click's loss goes down (or its adaptive report names its
stop), the CEM residual, undo restores the SR bit for bit, no layout built;
launches per G call over the clicks (the renders, a CUDA graph of the
image's shape, bit for bit against the session's forward eagerly) and per
Z step forward and backward (none) by hand; dloss/dZ through the kernels
against the bf16 and f32 plain paths (a band shown to fail an RDB kernel
that returns its input). A click's time is the
``esr_explore_click_lr128`` cell's.
"""

import numpy as np
import pytest
import torch

from esr_tpu_torch.explore import objectives as explore_obj
from esr_tpu_torch.explore import viewmodel as explore_vm
from esr_tpu_torch.explore.z_optimizer import bucket_crop
from esr_tpu_torch.ops.cuda import autograd as kernel_grads
from torch_card import (CEM_TOL, COUNTERS, EXPECTED_PER_FORWARD, EXPLORE_BOX, EXPLORE_LR, GRAD_BAND_FLOOR, NZ,  # noqa: F401
                        LAYOUT_COUNTERS, SCALE, SearchLog, explore_session, g0_pth, max_err, per_forward, plain_path,
                        rel_l2, selection_crop)

EXPLORE_STEPS = 32  # Z steps a search round: the session's 64, halved
CLICKS = ("imprint (adaptive)", "variance +", "variance -", "brightness 0.7", "smooth", "periodicity 0 8",
          "histogram", "realism +", "alternatives k=2, apply one", "smooth, no selection")


@pytest.fixture(scope="module")
def session(g0_pth, tmp_path_factory):
    sess = explore_session(tmp_path_factory.mktemp("explore"), g0_pth)
    sess.set_search_strength(n_steps=EXPLORE_STEPS)
    return sess


def _tools(sess, target):
    """The editor's tools, one click each, by ``CLICKS``' names."""
    patch = np.random.default_rng(12).random((48, 48, 3)).astype(np.float32) ** 2

    def alternatives():
        cands = sess.propose_alternatives(k=2, seed=0)
        sess.apply_alternative(cands[1][0])

    def full_image_smooth():
        sess._mask, sess._box_lr = None, None  # no selection: the whole 128 x 128
        return sess.smooth()

    return dict(zip(CLICKS, (lambda: sess.imprint(target), sess.increase_variance, sess.decrease_variance,
                             lambda: sess.brightness(0.7), sess.smooth, lambda: sess.periodicity(0.0, 8.0),
                             lambda: sess.match_histogram(patch, adaptive=False), lambda: sess.realism(1.0),
                             alternatives, full_image_smooth)))


@pytest.fixture(scope="module")
def clicks(session):
    """Every click on the selection, in turn, counters set to 0 just before
    the first: per click (loss went down, the CEM residual, undo restored,
    layouts built, Z steps); the launches, G calls and layouts built in all;
    and the imprint click's target."""
    sess, g, cem = session, session.g, session.cem
    lr = torch.from_numpy(sess.lr_img).to(sess.device)
    log = SearchLog(sess._optimizer)
    sess._optimizer = log
    forwards, renders = [0], [0]
    hook = log.hook(g, forwards)
    render = sess._render
    log.count_renders(sess, renders)
    sr = sess.current_sr()[0]
    y0, x0, y1, x1 = (v * SCALE for v in EXPLORE_BOX)
    alpha = explore_vm.render_text_mask("ESR", (y1 - y0, x1 - x0))[..., None]
    # an image imprinted over the selection (white text on mid gray): the
    # editor's text tool composites over the SR itself, where |sr - target|
    # is 0 outside the glyphs and JAX's |.| gradient at 0 (1) pushes Z there too
    target = sr.copy()
    target[y0:y1, x0:x1] = 0.5 * (1 - alpha) + alpha
    sess.select_rect(y0, x0, y1, x1)
    for c in COUNTERS:
        c.reset()
    forwards[0] = renders[0] = 0
    layouts0 = [c.count for c in LAYOUT_COUNTERS]
    out, steps = {}, 0
    for what, click in _tools(sess, target).items():
        sr_before = sess.current_sr().copy()
        n_traces = len(log.traces)
        builds0 = [c.count for c in LAYOUT_COUNTERS]
        click()
        torch.cuda.synchronize()
        traces = log.traces[n_traces:]
        rounds = sess.last_rounds if "adaptive" in what else None
        if rounds:  # better than the start, or stopped as insensitive at full escalation
            down = rounds[-1]["best"] < rounds[0]["first"] or rounds[-1].get("stop") == "insensitive-at-max-escalation"
        else:
            down = all(t[-1] < t[0] for t in traces)
        res = max_err(cem.downsample(torch.from_numpy(sess.current_sr()).to(lr.device)), lr)
        sess.undo()
        restored = np.array_equal(sess.current_sr(), sr_before)
        sess.redo()
        out[what] = {"down": down, "residual": res, "restored": restored, "steps": sum(len(t) for t in traces),
                     "builds": [c.count - b for c, b in zip(LAYOUT_COUNTERS, builds0)]}
        steps += out[what]["steps"]
    torch.cuda.synchronize()
    hook.remove()
    sess._render = render
    return {"clicks": out, "launches": {c.name: c.count for c in COUNTERS},
            "g_calls": forwards[0] + renders[0] + steps,
            "builds": [c.count - b for c, b in zip(LAYOUT_COUNTERS, layouts0)], "target": target}


@pytest.mark.cuda
def test_cuda_explore_session_as_the_cli_builds_it(session):
    """D attached for the realism tool, G frozen; the selection's bucket 64."""
    assert session._d is not None and not any(p.requires_grad for p in session.g.parameters())
    session.select_rect(*(v * SCALE for v in EXPLORE_BOX))
    assert session._box_lr == EXPLORE_BOX and bucket_crop(EXPLORE_BOX, EXPLORE_LR, EXPLORE_LR, SCALE)[2] == 64


@pytest.mark.cuda
@pytest.mark.parametrize("what", CLICKS)
def test_cuda_explore_click(clicks, what):
    """The click's loss goes down (the adaptive imprint: its best below its
    first, or its stop as insensitive at full escalation), the CEM residual
    within CEM_TOL, undo restores the SR bit for bit, no layout
    built, Z steps run."""
    c = clicks["clicks"][what]
    assert c["down"] and c["residual"] <= CEM_TOL and c["restored"] and c["builds"] == [0, 0] and c["steps"] > 0, c


@pytest.mark.cuda
def test_cuda_explore_clicks_launch_per_g_call(clicks):
    """Over the clicks, 69 / 4 / 2 launches a G call (each Z step's forward,
    each render, each call outside the searches): none in any backward; no
    layout built."""
    assert clicks["launches"] == per_forward(clicks["g_calls"]) and clicks["builds"] == [0, 0]


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_explore_render_is_a_graph_of_the_sessions_forward(session, clicks):  # noqa: ARG001
    """The render at LR 128 x 128 on the session's Z: its own forward, one
    CUDA graph of the image's shape, bit for bit the session's forward
    eagerly."""
    lr = torch.from_numpy(session.lr_img).to(session.device)
    zt = torch.from_numpy(session.z).to(lr.device)
    torch.backends.cudnn.deterministic = True
    try:
        same = torch.equal(session._render(lr, zt), session.forward(lr, zt))
    finally:
        torch.backends.cudnn.deterministic = False
    assert same and len(session._render.graphs.steps) == 1 and session._render is not session.forward


def _fixed_z(size):
    return torch.from_numpy(np.random.default_rng(14).uniform(-0.5, 0.5, (1, size, size, NZ)).astype(np.float32)).cuda()


@pytest.mark.cuda
def test_cuda_explore_z_step_launches_forward_only(session):
    """One Z step on the selection's 64 x 64 LR crop by hand: 69 / 4 / 2
    launches in the forward, none in the backward, no layout built."""
    lr_c, mask = selection_crop(torch.from_numpy(session.lr_img).to(session.device))
    zl = _fixed_z(lr_c.shape[1]).requires_grad_(True)
    objective = explore_obj.imprint_objective(torch.zeros(256, 256, 3, device=lr_c.device)).to(lr_c.device)
    for c in COUNTERS:
        c.reset()
    builds0 = [c.count for c in LAYOUT_COUNTERS]
    loss = objective(session.forward(lr_c, zl), mask)
    torch.cuda.synchronize()
    fwd = {c.name: c.count for c in COUNTERS}
    for c in COUNTERS:
        c.reset()
    torch.autograd.grad(loss, zl)
    torch.cuda.synchronize()
    assert fwd == EXPECTED_PER_FORWARD and not any(c.count for c in COUNTERS)
    assert [c.count for c in LAYOUT_COUNTERS] == builds0


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["above the SR", "the imprint click's"])
def test_cuda_explore_dloss_dz_band(session, clicks, target):
    """dloss/dZ of an imprint objective on the 64 x 64 LR crop at a fixed Z
    through the kernels: relative L2 to the f32 plain path within twice the
    bf16 plain path's (at least a bf16 half-ulp). On the target 0.2-0.4 above
    the f32 SR (|sr - target| keeps its sign on every path), the band fails
    a planted RDB kernel that returns its input; on the imprint click's own
    target, where the L1 changes sign pixel by pixel, bf16 rounding moves dZ
    by more, so the fault is not held there."""
    g, cem = session.g, session.cem
    lr = torch.from_numpy(session.lr_img).to(session.device)
    lr_c, mask = selection_crop(lr)
    y, x, size = bucket_crop(EXPLORE_BOX, EXPLORE_LR, EXPLORE_LR, SCALE)
    z_fixed = _fixed_z(size)
    if target == "above the SR":
        with torch.no_grad():
            sr_f = plain_path(g, cem, torch.float32)(lr_c, z_fixed)[0]
        tgt = sr_f + torch.from_numpy(np.random.default_rng(13).uniform(0.2, 0.4, tuple(sr_f.shape))
                                      .astype(np.float32)).to(lr.device)
    else:
        tgt = torch.from_numpy(np.ascontiguousarray(clicks["target"][y * SCALE : (y + size) * SCALE,
                                                                     x * SCALE : (x + size) * SCALE])).to(lr.device)
    obj = explore_obj.imprint_objective(tgt).to(lr.device)

    def dloss_dz(forward):
        zl = z_fixed.clone().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(obj(forward(lr_c, zl), mask), zl)[0]

    dz_k, dz_b, dz_f = (dloss_dz(f) for f in (session.forward, plain_path(g, cem, torch.bfloat16),
                                               plain_path(g, cem, torch.float32)))
    band = max(2 * rel_l2(dz_b, dz_f), GRAD_BAND_FLOOR)
    assert rel_l2(dz_k, dz_f) <= band
    if target == "above the SR":
        orig = kernel_grads.rdb5c_launch
        kernel_grads.rdb5c_launch = lambda x_, kw, *a, **k: x_.clone()
        try:
            assert rel_l2(dloss_dz(session.forward), dz_f) > band
        finally:
            kernel_grads.rdb5c_launch = orig
