"""Runs of the harness on the CPU at a toy size (the ``toy`` fixture), past
its look for a card: the result line's keys, the plain reference against
the port's plain path, the control failing the check, and the check
failing each fault the timed path of a cell can have. ``card`` tests run
the control at the cells' own sizes (``calibrate.py`` reads the same on
the chip)."""

import numpy as np
import pytest
import torch

from esr_bench import harness
from esr_bench import reference as ref
from esr_bench.reference import explore
from esr_bench.reference import train as reft

SEED = 2**33 + 12345
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, trace=False, seconds=0.3):
    return harness.run(cell, SEED, seconds, trace, "cpu", 0.0)


@pytest.mark.parametrize("cell", ["esr_eval_b16_lr128", "srresnet_eval_b16_lr128", "esr_explore_click_lr128",
                                  "esr_gan_train_b16_hr128"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(toy, cell, trace):
    out = run(cell, trace)
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(harness.load("workloads", cell)["limits"])
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2


# A traced window on the card: start marker at 100 us, end marker (long) at 2,000,100 us; the host saw 2.0 s.
_START = ("void at::cuda::(anonymous namespace)::spin_kernel(long)", 100.0, 101.5)
_END = ("void at::cuda::(anonymous namespace)::spin_kernel(long)", 2_000_100.0, 2_000_160.0)
_WORK = [("warm", 10.0, 90.0), ("k", 200.0, 1_000_200.0), ("k", 1_500_000.0, 1_900_000.0), ("fill", 2_000_170.0, 2_000_171.0)]


@pytest.mark.parametrize("kept", [(_START, _END), (_START,), (_END,)], ids=["both", "end_lost", "start_lost"])
def test_trace_window_from_its_markers(kept):
    tr = harness.reduce_trace(sorted(_WORK + list(kept), key=lambda e: e[1]), [], (5.0, 7.0))
    assert tr.window_s == pytest.approx(2.0) and tr.busy_s == pytest.approx(1.4)
    assert [name for name, _, _ in tr.kernels] == ["k", "k"]


@pytest.mark.parametrize("markers", [(), (_START, _START, _END)], ids=["none", "two_starts"])
def test_trace_without_one_marker_each_raises(markers):
    with pytest.raises(RuntimeError, match="markers"):
        harness.reduce_trace(_WORK + list(markers), [], (5.0, 7.0))


@pytest.mark.parametrize("fails", [1, 2])
def test_a_traced_window_that_fails_is_traced_once_more(toy, monkeypatch, fails):
    reduce, calls = harness.reduce_trace, []

    def flaky(*args):
        calls.append(1)
        if len(calls) <= fails:
            raise RuntimeError("the trace holds 0 start and 1 end spin_kernel markers, not one each")
        return reduce(*args)

    monkeypatch.setattr(harness, "reduce_trace", flaky)
    if fails == 2:
        with pytest.raises(RuntimeError, match="markers"):
            run("esr_eval_b16_lr128", trace=True)
    else:
        out = run("esr_eval_b16_lr128", trace=True)
        assert out["correct"] is True and len(calls) == 2 and "busy_s" in out["device"]


def _sd(shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) * (gain * (2.0 / np.prod(s[1:])) ** 0.5 if len(s) > 1 else gain)
            for k, (s, gain) in shapes.items()}


@pytest.mark.parametrize("config", ["esr_rrdb_x4_z1", "srresnet_x4_cem"])
def test_reference_generator_and_cem_match_the_ports_plain_path(toy, config):
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.models.networks import define_G

    from esr_bench.traffic.eval import port_options

    cfg = harness.load("configs", config)
    sd = _sd(ref.generator_shapes(cfg))
    g = define_G(dict(port_options(cfg), bf16=False), device="cpu")
    g.load_state_dict(sd, strict=True)
    lr = torch.rand(2, 12, 12, 3)
    nz = cfg["network_G"]["num_latent_channels"]
    z = torch.rand(2, 12, 12, nz) * 2 - 1 if nz else None
    cem = make_cem(CEMConf(scale=4), device="cpu")
    with torch.no_grad():
        port = cem.project(g(lr, z), lr)
        mine = ref.Cem(4, "cpu").project(ref.generator(sd, cfg, lr, z), lr)
    assert torch.allclose(port, mine, atol=1e-5, rtol=1e-5)


def test_reference_z_search_matches_the_ports(toy):
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.explore import objectives as obj
    from esr_tpu_torch.explore.z_optimizer import bucket_crop, optimize_z
    from esr_tpu_torch.models.networks import define_G

    from esr_bench.traffic.eval import port_options

    cfg = harness.load("configs", "esr_rrdb_x4_z1")
    sd = _sd(ref.generator_shapes(cfg))
    g = define_G(dict(port_options(cfg), bf16=False), device="cpu").requires_grad_(False)
    g.load_state_dict(sd, strict=True)
    cem, rcem = make_cem(CEMConf(scale=4), device="cpu"), ref.Cem(4, "cpu")
    gen = torch.Generator().manual_seed(7)
    lr, z0 = torch.rand(1, 16, 16, 3, generator=gen), torch.rand(1, 16, 16, 1, generator=gen) * 2 - 1
    m = torch.ones(64, 64)
    assert bucket_crop((3, 4, 30, 20), 40, 40, 4) == explore.crop_box((3, 4, 30, 20), 40, 40)
    for tool, objective in (({"name": "increase_variance"}, obj.variance_objective(1.0)),
                            ({"name": "smooth"}, obj.tv_objective()),
                            ({"name": "brightness", "level": 0.7}, obj.brightness_objective(0.7))):
        port, _ = optimize_z(lambda a, b: cem.project(g(a, b), a), lr, z0, m, objective, n_steps=5)
        mine = explore.z_search(lambda a, b: rcem.project(ref.generator(sd, cfg, a, b), a), lr, z0, m, tool, 5)
        # Adam divides by |g|: where a Z pixel's gradient is near rounding, rounding moves it
        assert torch.allclose(port, mine, atol=1e-3), tool


def test_reference_gan_steps_match_the_ports(toy):
    """The port's GAN steps in f32 (``bf16: false``) against the reference's."""
    from esr_tpu_torch.models import create_model

    from esr_bench.traffic.eval import port_options

    cfg = harness.load("configs", "esr_rrdb_x4_z1")
    opt = dict(port_options(cfg), bf16=False, is_train=True, path={}, logger={"print_freq": 200},
               datasets={"train": {"HR_size": 32, "batch_size": 2, "use_flip": True, "use_rot": True}})
    opt["train"] = dict(cfg["train"], manual_seed=5)
    m = create_model(opt, device="cpu")
    g, d, f = _sd(ref.generator_shapes(cfg), 1), _sd(reft.d_shapes(8, 32), 2), _sd(reft.vgg_shapes(), 3)
    for k in list(d):
        if k.startswith("bn") and k.endswith(".weight"):
            d[k] = torch.ones_like(d[k])
            d[k[:-7] + ".running_mean"], d[k[:-7] + ".running_var"] = torch.zeros_like(d[k]), torch.ones_like(d[k])
            d[k[:-7] + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for net, sd in zip((m.g_module, m.d_module, m.f_module), (g, d, f)):
        net.load_state_dict(sd, strict=True)
    batches = [np.random.default_rng(i).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8) for i in range(2)]
    port = []
    for step, hr in enumerate(batches, start=1):
        m.feed_data({"HR": hr})
        m.optimize_parameters(step)
        port.append(m.get_current_losses())
    mine = reft.train_steps(cfg, g, d, f, batches, 5 + 3, "cpu")
    for p, r in zip(port, mine):
        for k in ("l_g", "l_d", "l_g_fea", "l_g_gan", "l_g_map", "l_g_range", "l_g_pix"):
            assert abs(p[k] - r[k]) <= 1e-4 * abs(r[k]) + 1e-7, (k, p[k], r[k])
    # each leaf's change (Adam moves a leaf of rounding-sized gradient by the rounding's sign:
    # conv_last.bias has none, as the CEM removes a constant shift, so leaves under a
    # thousandth of the median gradient are left out, as the check leaves them out)
    for net, before, after in (("G", g, dict(m.g_module.named_parameters())),
                               ("D", d, dict(m.d_module.named_parameters()))):
        grads = {k: v.norm() for k, v in mine[0][f"grads_{net}"].items()}
        med = torch.stack(list(grads.values())).median()
        for k, v in after.items():
            if grads[k] >= 1e-3 * med:
                moved, want = (v - before[k]).norm(), (mine[-1][f"params_{net}"][k] - before[k]).norm()
                assert abs(moved - want) <= 1e-3 * want, (k, moved, want)
    for k, v in m.d_module.state_dict().items():
        if "running" in k:
            assert torch.allclose(v, mine[-1]["stats_D"][k], atol=1e-5), k


@pytest.mark.parametrize("cell", ["esr_eval_b16_lr128", "srresnet_eval_b16_lr128", "esr_explore_click_lr128",
                                  "esr_gan_train_b16_hr128"])
def test_control_fails_the_check_at_toy_size(toy, cell):
    bench = harness.Bench(cell, SEED, "cpu", False)
    traffic = harness.module("traffic", bench.kind).Traffic(bench)
    traffic.setup()
    harness._window(traffic, 0.2)
    traffic.release()
    assert all(v <= lim for _, v, lim in traffic.judge())
    assert any(v > lim for _, v, lim in traffic.control())


# -- the faults a cell's timed path can have, planted under a whole run ------


def _altered_answer(monkeypatch):
    from esr_tpu_torch.models import base_model

    call = base_model.EvalForward.__call__
    monkeypatch.setattr(base_model.EvalForward, "__call__", lambda self, lr, z=None: call(self, lr, z) * 1.02)


def _half_batch_forward(monkeypatch):
    from esr_tpu_torch.models import base_model

    call = base_model.EvalForward.__call__

    def half(self, lr, z=None):
        n = lr.shape[0] // 2
        out = call(self, lr[:n], None if z is None else z[:n])
        return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)])

    monkeypatch.setattr(base_model.EvalForward, "__call__", half)


def _state_unchanged(monkeypatch):
    from esr_tpu_torch.models import base_model

    monkeypatch.setattr(base_model.Adam, "step", lambda self, grads, lr=None, sq_sum=None: None)


def _state_unchanged_in_the_window(monkeypatch):
    """Adam's updates stop after set-up's step (its G and D updates): a fault
    that only the window's steps show."""
    from esr_tpu_torch.models import base_model

    step, calls = base_model.Adam.step, []

    def late(self, grads, lr=None, sq_sum=None):
        calls.append(1)
        if len(calls) <= 2:
            step(self, grads, lr, sq_sum)

    monkeypatch.setattr(base_model.Adam, "step", late)


def _half_batch_train(monkeypatch):
    from esr_tpu_torch.models import sr_model, srragan_model

    make = sr_model._pipeline

    def pipeline(*args, **kwargs):
        pipe = make(*args, **kwargs)

        def half(hr, gen, *a, **k):
            out = pipe(hr, gen, *a, **k)
            n = out["HR"].shape[0] // 2
            return {key: torch.cat([v[:n], v[:n]]) for key, v in out.items()}

        return half

    monkeypatch.setattr(srragan_model, "_pipeline", pipeline)


def _altered_render(monkeypatch):
    from esr_tpu_torch.explore import session

    current = session.ExplorationSession.current_sr
    monkeypatch.setattr(session.ExplorationSession, "current_sr", lambda self, z=None: current(self, z) * 1.02)


@pytest.mark.parametrize("cell,fault", [
    ("esr_eval_b16_lr128", _altered_answer), ("esr_eval_b16_lr128", _half_batch_forward),
    ("srresnet_eval_b16_lr128", _altered_answer), ("srresnet_eval_b16_lr128", _half_batch_forward),
    ("esr_explore_click_lr128", _state_unchanged), ("esr_explore_click_lr128", _altered_render),
    ("esr_gan_train_b16_hr128", _state_unchanged), ("esr_gan_train_b16_hr128", _state_unchanged_in_the_window),
    ("esr_gan_train_b16_hr128", _half_batch_train),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_fails_the_run(toy, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert run(cell)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", ["esr_eval_b16_lr128", "srresnet_eval_b16_lr128", "esr_explore_click_lr128",
                                  "esr_gan_train_b16_hr128"])
def test_control_fails_the_check_on_the_card(card, cell):
    bench = harness.Bench(cell, SEED, str(card), False)
    traffic = harness.module("traffic", bench.kind).Traffic(bench)
    traffic.setup()
    harness._window(traffic, 1.0)
    traffic.release()
    assert all(v <= lim for _, v, lim in traffic.judge())
    assert any(v > lim for _, v, lim in traffic.control())
