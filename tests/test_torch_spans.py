"""The port's spans (``utils/profiler.annotate``) on the CPU.

- Recording off: ``annotate`` hands back one shared no-op, records nothing
  and allocates nothing.
- Recording on (``recording()``, or a running ``torch.profiler`` profile):
  each span's parent, its root's identifier, ``waits``, and a root's
  ``LaunchCounter`` deltas; a thread's spans nest on its own stack; the
  buffer keeps the newest spans and counts the ones it drops. A profile
  outside ``trace()`` gets no ``record_function`` ranges.
- At toy sizes, the eval forward, the SR and GAN train steps and an editor
  tool call with its render each record exactly the span tree PERF.md lists,
  eagerly and through the stand-in for graph capture
  (tests/torch_fake_graphs.py).
- ``ZSearch.run(n)`` adds n to the ``z_steps`` counter, eagerly and graphed.
"""

from __future__ import annotations

import itertools
import threading
import tracemalloc

import numpy as np
import pytest
import torch

import torch_fake_graphs
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.explore import objectives as obj
from esr_tpu_torch.explore.session import ExplorationSession
from esr_tpu_torch.explore.z_optimizer import Z_STEPS, ZSearch, ZSearchCache
from esr_tpu_torch.models import create_model, define_G, make_eval_forward
from esr_tpu_torch.ops.cuda.lib import LaunchCounter
from esr_tpu_torch.options import parse
from esr_tpu_torch.utils import profiler
from esr_tpu_torch.utils.profiler import annotate, recorded, recording

torch.set_num_threads(1)

NET = {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4, "in_nc": 3, "out_nc": 3,
       "num_latent_channels": 1, "latent_input": "first_layer", "fold": 1}


def _tree(spans) -> list:
    """The spans as nested ``(name, [children])`` lists, roots first, in order of opening."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)

    def walk(parent):
        return [(s.name, walk(s.id)) for s in sorted(kids.get(parent, []), key=lambda s: s.id)]

    return walk(-1)


def _leaves(*names) -> list:
    return [(n, []) for n in names]


def _allocated_peak(fn) -> int:
    tracemalloc.start()
    try:
        fn(10)
        tracemalloc.reset_peak()
        now, _ = tracemalloc.get_traced_memory()
        fn(10_000)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return peak - now


def test_recording_off_records_nothing_and_allocates_nothing():
    before = recorded()
    no_op = annotate("a")
    assert annotate("b", 3, waits=True) is no_op
    with no_op as got:
        assert got is None
    assert len(recorded().spans) == len(before.spans) and recorded().dropped == before.dropped

    def empty(n):
        for _ in itertools.repeat(None, n):
            pass

    def calls(n):
        for _ in itertools.repeat(None, n):
            annotate("train.upload", 7, waits=True)

    assert _allocated_peak(calls) == _allocated_peak(empty)


def test_recorded_spans_carry_parent_root_and_waits():
    counter = LaunchCounter("test_spans")
    inner = []

    def other_thread():
        with annotate("thread.root", 99), annotate("thread.child"):
            inner.append(threading.get_ident())

    try:
        with recording() as rec:
            with annotate("train.step", 12):
                counter.count += 3
                with annotate("train.upload", waits=True):
                    t = threading.Thread(target=other_thread)
                    t.start()
                    t.join(timeout=30)
                with annotate("graphs.replay", 5):  # a root argument below a root is ignored
                    pass
            with annotate("eval.forward"):
                pass
    finally:
        LaunchCounter.all.remove(counter)
    assert not t.is_alive() and inner
    by = {s.name: s for s in rec.spans}
    step, upload, replay, fwd = by["train.step"], by["train.upload"], by["graphs.replay"], by["eval.forward"]
    assert step.parent == -1 and step.root == 12 and step.counts == {"test_spans": 3} and not step.waits
    assert upload.parent == replay.parent == step.id and upload.root == replay.root == 12
    assert upload.waits and not replay.waits and upload.counts is None
    assert fwd.parent == -1 and fwd.root == fwd.id and fwd.counts == {}
    assert step.start_ns <= upload.start_ns <= upload.end_ns <= replay.start_ns <= replay.end_ns <= step.end_ns
    # the other thread's spans nest on their own stack, not under train.upload
    assert by["thread.root"].parent == -1 and by["thread.root"].root == 99
    assert by["thread.child"].parent == by["thread.root"].id and by["thread.child"].root == 99
    assert [s.name for s in rec.spans][-1] == "eval.forward" and rec.dropped == 0


def test_the_buffer_keeps_the_newest_spans_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiler, "_REC", profiler._Recorder(4))
    with recording() as rec:
        for i in range(10):
            with annotate(f"s{i}"):
                pass
    assert [s.name for s in rec.spans] == ["s6", "s7", "s8", "s9"] and rec.dropped == 6
    assert recorded().dropped == 6 and len(recorded().spans) == 4


def test_a_running_profile_records_spans_without_ranges():
    """The benchmark's traced window runs ``torch.profiler`` and reads the
    port's spans from memory; outside ``trace()`` they are no
    ``record_function`` ranges on that profile."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("zz_probe_span", 4):
            (x @ x).sum()
    assert annotate("zz_probe_span") is annotate("other")  # off again
    got = [s for s in recorded().spans if s.name == "zz_probe_span"]
    assert got and got[-1].root == 4
    assert not any("zz_probe_span" in e.key for e in prof.key_averages())


def test_a_torch_without_the_profilers_flag_records_in_recording_alone(monkeypatch):
    """The profile's flag is a private name of torch: where a release lacks
    it, the module imports, a profile records nothing and ``recording()``
    still records."""
    import importlib.util

    from torch.profiler import ProfilerActivity, profile

    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    spec = importlib.util.spec_from_file_location("profiler_without_flag", profiler.__file__)
    bare = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bare)
    assert bare._TORCH_PROFILER is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert bare.annotate("zz_bare_span") is bare.annotate("other")
    with bare.recording() as rec:
        with bare.annotate("zz_bare_span", 6):
            pass
    assert [(s.name, s.root) for s in rec.spans] == [("zz_bare_span", 6)]


def _small_g(seed: int = 0):
    g = define_G({"network_G": dict(NET), "scale": 4, "bf16": False}, device="cpu", seed=seed)
    return g, make_cem(CEMConf(scale=4), device="cpu")


REPLAYED = [("graphs.copy_in", []), ("graphs.replay", [])]


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_eval_forward_span_tree(monkeypatch, graphed):
    if graphed:
        torch_fake_graphs.install(monkeypatch)
    g, cem = _small_g()
    fwd = make_eval_forward(g, cem)
    fwd.graphs.enabled = graphed
    lr = torch.rand(1, 8, 8, 3)
    with recording() as rec:
        fwd(lr)
        fwd(lr)
    first = _leaves("graphs.copy_in", "graphs.capture", "eval.clone") if graphed else []
    second = REPLAYED + _leaves("eval.clone") if graphed else []
    assert _tree(rec.spans) == [("eval.forward", first), ("eval.forward", second)]
    assert [s.root for s in rec.spans if s.parent == -1] == [1, 2]


def _train_opt(model: str) -> dict:
    opt = {"name": "spans", "model": model, "scale": 4, "use_cem": True, "bf16": False, "path": {"root": "unused"},
           "datasets": {"train": {"name": "syn", "mode": "SYNTHETIC", "n_images": 2, "image_size": 32,
                                  "batch_size": 2, "HR_size": 32}},
           "network_G": dict(NET), "network_D": {"which_model_D": "discriminator_vgg_128", "nf": 8, "norm_type": "batch"},
           "train": {"lr_G": 1e-4, "lr_D": 1e-4, "pixel_weight": 0.01, "feature_weight": 1.0, "gan_weight": 0.005,
                     "manual_seed": 0, "watchdog": False},
           "logger": {"print_freq": 1}}
    if model == "sr":
        opt["train"].update(pixel_weight=1.0)
    return opt


@pytest.mark.parametrize("model", ["sr", "srragan"])
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_train_step_span_tree(monkeypatch, model, graphed):
    if graphed:
        torch_fake_graphs.install(monkeypatch)
    m = create_model(parse(_train_opt(model), is_train=True), device="cpu")
    m._step_graphs.enabled = graphed
    hr = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    with recording() as rec:
        for step in (1, 2):
            m.feed_data({"HR": hr})
            m.optimize_parameters(step)
        losses = m.get_current_losses()
    assert losses and all(np.isfinite(v) for v in losses.values())
    host = [("train.upload", []), ("train.pipeline", _leaves("resize.upload", "pipeline.upload")),
            ("train.scalars", []), ("train.stage", [])]
    first = host + (_leaves("graphs.copy_in", "graphs.capture") if graphed else [])
    second = host + (REPLAYED if graphed else [])
    assert _tree(rec.spans) == [("train.step", first), ("train.step", second), ("train.losses", [])]
    roots = [s for s in rec.spans if s.parent == -1]
    assert [s.root for s in roots[:2]] == [1, 2] and roots[2].waits
    uploads = ["train.upload", "resize.upload", "pipeline.upload"]
    assert [s.name for s in rec.spans if s.waits] == uploads * 2 + ["graphs.replay"] * graphed + ["train.losses"]


def _search(replays: int, captured: bool) -> list:
    run = [("graphs.capture", [])] * captured + [("graphs.replay", [])] * replays
    return [("zopt.load", []), ("zopt.run", run), ("zopt.fetch", [])]


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_tool_call_span_tree(monkeypatch, graphed):
    if graphed:
        torch_fake_graphs.install(monkeypatch)
    g, cem = _small_g()
    lr = np.random.default_rng(1).random((24, 24, 3)).astype(np.float32)
    sess = ExplorationSession(g, cem, lr, num_latent_channels=1, n_steps=3)
    sess._render.graphs.enabled = graphed
    sess.select_rect(8, 8, 40, 40)
    with recording() as rec:
        for _ in range(2):
            sess.smooth()
            sess.current_sr()
    tool = [("explore.history", []), ("zopt.upload", []), ("zopt.crop", []), ("zopt.lookup", [])]
    tail = [("zopt.paste", []), ("explore.fetch", [])]
    render_first = _leaves("graphs.copy_in", "graphs.capture", "eval.clone") if graphed else []
    render_next = REPLAYED + _leaves("eval.clone") if graphed else []

    def render(inner):
        return ("explore.render", [("explore.upload", []), ("eval.forward", inner), ("explore.fetch", [])])

    steps = (2, True) if graphed else (0, False)
    again = (3, False) if graphed else (0, False)
    assert _tree(rec.spans) == [
        ("explore.tool", tool + [("zopt.search", _search(*steps))] + tail), render(render_first),
        ("explore.tool", tool + [("zopt.search", _search(*again))] + tail), render(render_next)]
    roots = [s for s in rec.spans if s.parent == -1]
    assert [s.root for s in roots] == [1, 1, 2, 2]
    assert [r.counts.get("z_steps", 0) for r in roots] == [3, 0, 3, 0]
    assert {s.name for s in rec.spans if s.waits} == {"zopt.upload", "zopt.fetch", "explore.fetch", "explore.upload",
                                                      *["graphs.replay"] * graphed}


def test_adaptive_tool_call_spans_each_round(monkeypatch):
    torch_fake_graphs.install(monkeypatch)
    g, cem = _small_g()
    lr = np.random.default_rng(2).random((16, 16, 3)).astype(np.float32)
    sess = ExplorationSession(g, cem, lr, num_latent_channels=1, n_steps=2)
    sess.select_rect(0, 0, 32, 32)
    with recording() as rec:
        sess.imprint(np.full((64, 64, 3), 0.5, np.float32))
    (root,) = [s for s in rec.spans if s.parent == -1]
    (search,) = [s for s in rec.spans if s.name == "zopt.search"]
    rounds = len(sess.last_rounds)
    inner = [s.name for s in rec.spans if s.parent == search.id]
    assert inner == ["zopt.load", "zopt.run", "zopt.fetch"] * rounds
    assert root.counts["z_steps"] == 2 * rounds


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_z_search_run_counts_its_steps(monkeypatch, graphed):
    if graphed:
        torch_fake_graphs.install(monkeypatch)
    g, cem = _small_g()
    g.requires_grad_(False)

    def forward(lr, z):
        return cem.project(g(lr, z), lr)

    lr, z0, mask = torch.rand(1, 8, 8, 3), torch.zeros(1, 8, 8, 1), torch.ones(32, 32)
    fn = obj.tv_objective().fn
    cache = ZSearchCache()
    search, made = cache.find(forward, lr, z0, mask, fn, {})
    assert made and isinstance(search, ZSearch) and search.step.enabled == graphed
    assert cache.find(forward, lr, z0, mask, fn, {}) == (search, False)
    before = Z_STEPS.count
    search.set_round(1.0)
    search.run(4, lambda count: 0.1)
    assert Z_STEPS.count - before == 4
    search.run(3, lambda count: 0.1)
    assert Z_STEPS.count - before == 7
