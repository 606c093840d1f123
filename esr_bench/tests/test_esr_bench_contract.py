"""The benchmark's files: every cell, configuration, mix and metric is found
by name and well formed, ``BENCHMARK.json`` agrees with them, the import
check compares whole top-level names, and the roofline arithmetic matches
the hand counts."""

import json
import re
import sys
import types

import pytest

from esr_bench import harness, roofline

ROOT = harness.BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["esr_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / SPEC["command"][1]).is_file() and SPEC["command"][1].startswith("esr_bench/")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    data = harness.load("workloads", cell)
    assert {k: data[k] for k in ("config", "traffic", "chips", "why")} == {k: entry[k] for k in
                                                                           ("config", "traffic", "chips", "why")}
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    mix = harness.load("traffic", data["traffic"])
    assert (harness.BENCH / "traffic" / f"{mix['kind']}.py").is_file()
    assert data["limits"] and all(isinstance(v, float | int) for v in data["limits"].values())
    assert any(c["name"] == data["config"] for c in SPEC["configs"])


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and config["source"].startswith("https://") and len(config["why"]) <= 200
    assert config["file"] == f"esr_bench/configs/{config['name']}.json"
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"] == []
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert set(metric["workloads"] if "workloads" in metric else CELLS) <= set(CELLS)
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
        return
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    reader = harness.module("metrics", metric["name"])
    assert reader.UNIT == metric["unit"]
    moves = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moves.get("workloads", CELLS))
    assert "roofline" not in metric["name"] or metric["name"].split(".")[0].endswith("_roofline")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_every_metric_file_is_named_in_the_spec():
    names = {m["name"] for m in SPEC["per_layer"]}
    files = {p.stem for p in (harness.BENCH / "metrics").glob("*.py")}
    assert names <= files


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name,caught", [("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
                                         ("esr_tpu", True), ("esr_tpu.models", True), ("esr_tpu_torch", False),
                                         ("esr_tpu_torch.models", False), ("jaxtyping", False)])
def test_import_check_compares_whole_top_level_names(monkeypatch, name, caught):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) is caught


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in (harness.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|esr_tpu)\b", text, re.M), path


def test_roofline_hand_counts():
    cfg = harness.load("configs", "esr_rrdb_x4_z1")
    convs = roofline.generator_convs(cfg, 16, 128, 128)
    rdb = [c for c in convs if c.kernel == "rdb5c_tc_kernel"]
    assert len(rdb) == 69 and rdb[0].kernel_flops / 2 / (16 * 128 * 128) == 239_616
    assert round(roofline.bound_s(rdb[0].kernel_flops, rdb[0].bytes) * 1e3, 3) == 0.127
    assert roofline.model_flops(cfg, 1, 1, 1) / 2 == 17_927_424
    conv = [c for c in convs if c.kernel == "conv_tc_kernel"]
    assert round(sum(roofline.bound_s(c.kernel_flops, c.bytes) for c in conv) * 1e3, 3) == 0.769
    srres = harness.load("configs", "srresnet_x4_cem")
    assert roofline.model_flops(srres, 1, 1, 1) / 2 == 2_572_992
    assert len(roofline.generator_convs(srres, 16, 128, 128)) == 38
    assert round(roofline.gan_step_flops(cfg, 16, 128) / 1e12, 2) == 2.94
