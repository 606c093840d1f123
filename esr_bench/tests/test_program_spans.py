"""The port's spans as the benchmark reads them (``esr_bench/program.py``):
idle gaps put down to the innermost open program span, the card-clock
offset from the harness's enclosing spans, the host / wait split; the three
readers of the port's spans on toy runs; the seven earlier readers
unchanged by what the port records; and a port with no recorder."""

import importlib.util
import json
from pathlib import Path

import pytest

from esr_bench import harness, program
from esr_tpu_torch.utils import profiler
from esr_tpu_torch.utils.profiler import Span

SEED = 2**33 + 54321
NEW = ("train_host_ms", "train_wait_ms", "z_step_ms.search")
EARLIER = ("rdb5c_roofline.eval", "conv3x3_roofline.eval", "eval_mfu_pct", "device_idle_pct.eval", "train_mfu_pct",
           "device_idle_pct.train", "z_step_ms")


def _span(i, name, a_us, b_us, parent=-1, waits=False):
    return Span(i, name, int(a_us * 1e3), int(b_us * 1e3), parent, 0, waits, {} if parent == -1 else None)


def test_idle_gaps_go_to_the_innermost_open_program_span():
    # the card busy over [0, 10), [20, 30), [50, 60), [70, 100) of a window [0, 100) us
    busy = [[0.0, 10.0], [20.0, 30.0], [50.0, 60.0], [70.0, 100.0]]
    harness_spans = [("optimize_parameters", 5.0, 65.0)]
    prog = [("train.step", 6.0, 64.0), ("train.upload", 8.0, 12.0), ("train.stage", 30.0, 55.0),
            ("graphs.replay", 31.0, 33.0)]
    idle = program.idle_by_span(busy, (0.0, 100.0), harness_spans, prog)
    # at 10 the upload is open; at 30 the stage (the replay begins after); at 60 only the root
    assert idle == pytest.approx({"optimize_parameters/train.upload": 10e-6,
                                  "optimize_parameters/train.stage": 20e-6,
                                  "optimize_parameters/train.step": 10e-6})
    # a gap that begins after the harness span: no span; inside it with no program span open: the harness's
    assert program.idle_by_span([[0.0, 70.0]], (0.0, 100.0), harness_spans, prog) == pytest.approx(
        {"(no span)": 30e-6})
    assert program.idle_by_span([[0.0, 70.0]], (0.0, 100.0), [("optimize_parameters", 5.0, 80.0)], prog) == \
        pytest.approx({"optimize_parameters": 30e-6})


def test_card_offset_fits_each_root_inside_its_harness_span():
    # host times (ns) of two roots; on the card the harness spans sit 1000 us later, each root 3 / 5 us in
    roots = [_span(0, "explore.tool", 100.0, 200.0), _span(1, "explore.tool", 500.0, 650.0)]
    harness_spans = [("tool.smooth", 1097.0, 1205.0), ("tool.brightness", 1495.0, 1660.0)]
    assert program.card_offset_us(harness_spans, roots) == pytest.approx(997.0)  # the 3 us pair bounds it
    assert program.card_offset_us(harness_spans[:1], roots) is None
    assert program.card_offset_us([("tool.smooth", 1097.0, 1150.0), harness_spans[1]], roots) is None


def test_host_and_wait_split_each_root():
    spans = [_span(1, "train.upload", 0.0, 4.0, parent=0, waits=True),
             _span(2, "train.pipeline", 4.0, 6.0, parent=0),
             _span(0, "train.step", 0.0, 10.0),
             _span(4, "train.upload", 20.0, 21.0, parent=3, waits=True),
             _span(5, "graphs.replay", 21.0, 30.0, parent=3),
             _span(3, "train.step", 20.0, 30.0)]
    roots = program.window_roots(spans, "train.step", 2)
    assert [r.id for r in roots] == [0, 3] and program.window_roots(spans, "train.step", 3) == []
    assert [[s.id for s in below] for below in program.under(spans, roots)] == [[1, 2], [4, 5]]
    assert program.host_and_wait_ns(spans, roots) == (15_000, 5_000)
    assert program.host_and_wait_ns(spans, roots[1:]) == (9_000, 1_000)


def _run(cell, trace=True):
    return harness.run(cell, SEED, 0.3, trace, "cpu", 0.0)


@pytest.mark.parametrize("cell,present", [("esr_gan_train_b16_hr128", {"train_host_ms", "train_wait_ms"}),
                                          ("esr_explore_click_lr128", set()),
                                          ("esr_eval_b16_lr128", set())])
def test_readers_of_the_ports_spans_on_a_toy_run(toy, cell, present):
    """With the port recording (as it does under the card's profiler), the
    span readers read their cells; ``z_step_ms.search`` needs the card's busy
    time, which a CPU run has none of. Host and wait split a step."""
    with profiler.recording() as rec:
        out = _run(cell)
    assert out["correct"] is True and rec.dropped == 0
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NEW}
    assert set(got) == present
    assert all(v > 0 for k, v in got.items() if k != "train_wait_ms")
    if "train_host_ms" in got:
        longest = max(s.end_ns - s.start_ns for s in rec.spans if s.name == "train.step") / 1e6
        assert got["train_host_ms"] + got["train_wait_ms"] <= longest


@pytest.mark.parametrize("cell", ["esr_gan_train_b16_hr128", "esr_explore_click_lr128"])
def test_a_port_without_the_recorder(toy, monkeypatch, cell):
    """The parent's port has no ``recorded``: the run ends as before and
    none of the three new metrics is in its line."""
    monkeypatch.delattr(profiler, "recorded")
    with profiler.recording():
        out = _run(cell)
    assert out["correct"] is True and not set(out["metrics"]) & set(NEW)


def _ctx(kind):
    from types import SimpleNamespace

    cfg = harness.load("configs", "esr_rrdb_x4_z1")
    counts = {"eval": {"forwards": 4, "lr_shape": (16, 128, 128)}, "train": {"steps": 4, "batch": 16, "hr_size": 128},
              "clicks": {"clicks": 2, "z_steps": 128}}[kind]
    kernels = [("void esr::rdb5c_tc_kernel<64, 32, 16>", 0.0, 550.0)] * 276 + [("conv_tc_kernel", 0.0, 240.0)] * 24
    return SimpleNamespace(kind=kind, cfg=cfg, mix={}, counts=counts, units=4, kernels=kernels,
                           busy=[[0.0, 1.5e6], [1.6e6, 3.0e6]], spans=[("tool.smooth", 0.0, 2.9e6)],
                           busy_s=2.9, window_s=3.0, clean=SimpleNamespace(units=40, window_s=3.1),
                           clean_counts=counts)


@pytest.mark.parametrize("name", EARLIER)
@pytest.mark.parametrize("kind", ["eval", "train", "clicks"])
def test_earlier_readers_read_the_same_with_the_ports_spans(name, kind):
    reader = harness.module("metrics", name)
    before = reader.read(_ctx(kind))
    with profiler.recording():
        with profiler.annotate("train.step", 1), profiler.annotate("train.upload", waits=True):
            pass
    assert reader.read(_ctx(kind)) == before


def _span_breakdown():
    path = Path(__file__).resolve().parents[2] / "tools" / "span_breakdown.py"
    spec = importlib.util.spec_from_file_location("span_breakdown", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("cell,roots", [("esr_gan_train_b16_hr128", {"train.step", "train.losses"}),
                                        ("esr_explore_click_lr128", {"explore.tool", "explore.render"})])
def test_span_breakdown_runs_a_toy_cell(toy, monkeypatch, tmp_path, capsys, cell, roots):
    """``tools/span_breakdown.py`` on the CPU (``--device cpu``, the traced
    window recorded by ``recording()``, as no profile runs there): the run
    is correct, each root name is split into host and wait, the losses'
    fetch (every 2 steps here) is counted under ``train.losses``, and, with
    the card taken as busy in the first half of each harness span, each
    idle gap is put down to the program span open at its start. The harness
    is left as it was."""
    load, reduce = harness.load, harness.reduce_trace

    def losses_every_two_steps(kind, name):
        d = load(kind, name)
        return dict(d, print_freq=2) if kind == "traffic" and d["kind"] == "train" else d

    def busy_first_halves(events, spans, marks):
        tr = reduce(events, spans, marks)
        tr.busy = [[a, (a + b) / 2] for _, a, b in tr.spans]
        tr.busy_s = sum(b - a for a, b in tr.busy) / 1e6
        return tr

    monkeypatch.setattr(harness, "load", losses_every_two_steps)
    monkeypatch.setattr(harness, "reduce_trace", busy_first_halves)
    patched = (harness.reduce_trace, harness._traced_window, harness._window)
    out_file = tmp_path / "out.json"
    with profiler.recording():
        rc = _span_breakdown().main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                                     "--out", str(out_file), "--device", "cpu"])
    assert rc == 0 and (harness.reduce_trace, harness._traced_window, harness._window) == patched
    out = json.loads(out_file.read_text())
    assert out == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"] == "cpu"
    for part in (out["breakdown"], out["untraced"]):
        assert set(part["roots"]) == roots and "error" not in part
        assert all(r["host_ms"] > 0 and r["count"] > 0 for r in part["roots"].values())
    idle = dict(out["breakdown"]["idle_s"])
    assert sum(idle.values()) == pytest.approx(out["breakdown"]["window_s"] - out["breakdown"]["busy_s"], rel=1e-6)
    callers = ("optimize_parameters", "feed", "log") if "train" in cell else ("tool.", "select", "render")
    assert all(k == "(no span)" or k.startswith(callers) for k in idle)
    named = {k.split("/")[0].split(".")[0]: k.split("/", 1)[1] for k in idle if "/" in k}
    if "train" in cell:
        assert "log/train.losses" in idle and named.get("optimize_parameters", "").startswith(("train.", "graphs."))
    else:
        assert named.get("tool", "").startswith(("explore.", "zopt.", "graphs.")) and "render" in named
