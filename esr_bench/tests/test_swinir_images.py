"""The two whole-image cells (``traffic/images.py``): SwinIR-M behind the
CEM (``swinir_eval_div2k_b4``) and the explorable RRDB on one DIV2K-sized
image with four Z draws (``esr_eval_div2k_b4``), run on the CPU at a toy
size of their own (``toy_images``: SwinIR at embed 12, 2 heads, window 4,
depths [2, 2]; the RRDB at nf 8, nb 1, gc 4; LR 10 x 13, which the window
pads to 12 x 16, so that both shifts and the mask occur); the control and
each planted attention fault failing the check; the hand counts of
``roofline_swinir.py``; the readers on a toy trace."""

import copy

import pytest
import torch

from esr_bench import harness, program, roofline_swinir
from esr_bench.traffic import images
from esr_tpu_torch.utils.profiler import Span

SEED = 2**33 + 20202
CELLS = ["swinir_eval_div2k_b4", "esr_eval_div2k_b4"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def shrink(kind: str, data: dict) -> dict:
    """The cells' configurations and mixes at a size the CPU runs in seconds, in float32."""
    d = copy.deepcopy(data)
    if kind == "configs":
        d["bf16"] = False
        if d["network_G"]["which_model_G"] == "SwinIR":
            d["network_G"].update(embed_dim=12, depths=[2, 2], num_heads=[2, 2], window_size=4)
        else:
            d["network_G"].update(nf=8, nb=1, gc=4)
    elif kind == "traffic" and d["kind"] == "images":
        d.update(images=min(d["images"], 2), z_draws=min(d["z_draws"], 2), lr_h=10, lr_w=13, pool=2,
                 trace_seconds=0.3)
    return d


@pytest.fixture
def toy_images(monkeypatch):
    real = harness.load
    monkeypatch.setattr(harness, "load", lambda kind, name: shrink(kind, real(kind, name)))


def run(cell, trace=False):
    return harness.run(cell, SEED, 0.3, trace, "cpu", 0.0)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(toy_images, cell, trace):
    out = run(cell, trace)
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == {"sr_rel_err", "cem_residual"}
    if not trace:
        assert set(out["metrics"]) == {"eval_hr_mp_per_s", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check_at_toy_size(toy_images, cell):
    bench = harness.Bench(cell, SEED, "cpu", False)
    traffic = harness.module("traffic", bench.kind).Traffic(bench)
    traffic.setup()
    harness._window(traffic, 0.2)
    traffic.release()
    assert all(v <= lim for _, v, lim in traffic.judge())
    assert any(v > lim for _, v, lim in traffic.control())


@pytest.mark.parametrize("fault", images.FAULTS)
def test_an_attention_fault_fails_the_run(toy_images, monkeypatch, fault):
    """Each fault planted in the port's attention under a whole run fails
    ``sr_rel_err``; ``faults()`` (what ``calibrate.py`` reads) sees it too."""
    from esr_tpu_torch.models import blocks

    bench = harness.Bench("swinir_eval_div2k_b4", SEED, "cpu", False)
    traffic = images.Traffic(bench)
    traffic.setup()
    checks = traffic.faults()[fault]
    assert dict((n, v > lim) for n, v, lim in checks)["sr_rel_err"]
    monkeypatch.setattr(blocks, "window_attention", images.faulty_attention(fault))
    out = run("swinir_eval_div2k_b4")
    assert out["correct"] is False and out["checks"]["sr_rel_err"]["value"] > out["checks"]["sr_rel_err"]["limit"]


def test_the_unfaulted_plain_attention_is_the_ports():
    """``faulty_attention`` with no fault named is the port's plain attention."""
    from esr_tpu_torch.ops.cuda import window_attn

    g = torch.Generator().manual_seed(0)
    qkv, bias = torch.randn(2, 8, 12, 36, generator=g), torch.randn(2, 16, 16, generator=g)
    for shift in (0, 2):
        torch.testing.assert_close(images.faulty_attention("none")(qkv, bias, 2, 4, shift),
                                   window_attn.window_attention_reference(qkv, bias, 2, 4, shift))


def test_hand_counts():
    cfg = harness.load("configs", "swinir_m_x4_real")
    assert roofline_swinir.macs_per_pixel(cfg) == 13_665_132
    assert roofline_swinir.padded(cfg, 339, 510) == (344, 512)
    assert round(roofline_swinir.attention_bound_s(cfg, 4, 339, 510) * 1e3, 3) == 0.303
    assert roofline_swinir.attention_bytes(cfg, 1, 1, 1) / 64 == 1_440  # a token: q, k, v in, o out, bf16
    assert roofline_swinir.attention_flops(cfg, 1, 8, 8) / 64 == 46_080
    assert round(roofline_swinir.model_flops(cfg, 4, 339, 510) / 1e12, 2) == 19.25


def _ctx(cell, roots, kernels, lr_shape):
    bench_cfg = harness.load("configs", harness.load("workloads", cell)["config"])
    from types import SimpleNamespace

    return SimpleNamespace(kind="images", cfg=bench_cfg, units=len(roots), kernels=kernels,
                           counts={"forwards": len(roots), "lr_shape": lr_shape})


def _roots(n, counts):
    return [Span(i, "eval.forward", 1000 * i, 1000 * i + 500, -1, i, False, dict(counts)) for i in range(n)]


@pytest.mark.parametrize("metric,cell,counter,kernel,lr_shape", [
    ("window_attn_roofline.images", "swinir_eval_div2k_b4", "window_attn", "window_attn_kernel(AttnArgs)",
     (4, 339, 510)),
    ("rdb5c_roofline.images", "esr_eval_div2k_b4", "rdb5c", "void esr::rdb5c_tc_kernel<64, 32, 16>(...)",
     (4, 339, 510)),
])
def test_readers_on_a_toy_trace(monkeypatch, metric, cell, counter, kernel, lr_shape):
    """Two forwards of 36 (or 69) launches counted on their roots, the
    trace's records of the kernel at twice the bound each: 50%. A port
    without the counter, or a trace without the kernel, reads nothing; so
    does every other kind of cell."""
    reader = harness.module("metrics", metric)
    per = 36 if counter == "window_attn" else 69
    cfg = harness.load("configs", harness.load("workloads", cell)["config"])
    if counter == "window_attn":
        bound_ms = roofline_swinir.attention_bound_s(cfg, *lr_shape) * 1e3
    else:
        from esr_bench import roofline

        rdb = [c for c in roofline.generator_convs(cfg, *lr_shape) if c.kernel == "rdb5c_tc_kernel"][0]
        bound_ms = roofline.bound_s(rdb.kernel_flops, rdb.bytes) * 1e3
    kernels = [(kernel, 10.0 * i, 2e3 * bound_ms) for i in range(2 * per)] + [("other", 0.0, 50.0)]
    earlier = _roots(2, {counter: per})  # the warm units before the window
    monkeypatch.setattr(program, "spans", lambda: earlier + _roots(2, {counter: per}))
    ctx = _ctx(cell, [0, 1], kernels, lr_shape)
    assert reader.read(ctx) == pytest.approx(50.0, rel=1e-9)
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {}))
    assert reader.read(ctx) is None
    monkeypatch.setattr(program, "spans", lambda: None)
    assert reader.read(ctx) is None
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {counter: per}))
    assert reader.read(_ctx(cell, [0, 1], [("other", 0.0, 5.0)], lr_shape)) is None
    ctx.kind = "eval"
    assert reader.read(ctx) is None


def test_swinir_conv_sites():
    """SwinIR-M's 13 convs on ``conv_tc_kernel`` (11 in 3x3 mode, the two x2
    stages in parity mode), at the padded LR; their published FLOPs are the
    forward's less its 36 Swin blocks'."""
    cfg = harness.load("configs", "swinir_m_x4_real")
    sites = roofline_swinir.generator_convs(cfg, 4, 339, 510)
    assert [c.site for c in sites][:2] == ["conv_first", "layers.0.conv"] and len(sites) == 13
    assert {c.kernel for c in sites} == {"conv_tc_kernel"}
    g = cfg["network_G"]
    c, ws, hidden = g["embed_dim"], g["window_size"], int(g["mlp_ratio"] * g["embed_dim"])
    blocks = sum(g["depths"]) * (c * 3 * c + 2 * ws * ws * c + c * c + 2 * c * hidden) * 2.0 * 4 * 344 * 512
    assert sum(s.model_flops for s in sites) == pytest.approx(roofline_swinir.model_flops(cfg, 4, 339, 510) - blocks,
                                                              rel=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_whole_forward_readers_on_a_toy_trace(cell):
    """``conv_tc_kernel``'s records of two forwards at twice their summed
    bound read 50%; a traced window half busy, 50% idle; the untraced
    window's forwards in twice their time at the peak, 50% MFU. A trace
    without the kernel or with nothing busy reads nothing; nor does any
    other kind of cell."""
    from types import SimpleNamespace

    from esr_bench import roofline

    cfg = harness.load("configs", harness.load("workloads", cell)["config"])
    lr_shape = (4, 339, 510)
    count = roofline_swinir if cell.startswith("swinir") else roofline
    sites = [c for c in count.generator_convs(cfg, *lr_shape) if c.kernel == "conv_tc_kernel"]
    assert len(sites) == (13 if cell.startswith("swinir") else 6)
    kernels = [("void esr::conv_tc_kernel<64, 3, 0, 1, false>(...)", 10.0 * i,
                2e6 * roofline.bound_s(c.kernel_flops, c.bytes)) for i, c in enumerate(2 * sites)]
    flops = count.model_flops(cfg, *lr_shape)
    counts = {"forwards": 3, "lr_shape": lr_shape}
    ctx = SimpleNamespace(kind="images", cfg=cfg, counts=counts, kernels=kernels + [("other", 0.0, 5.0)],
                          busy_s=1.0, window_s=2.0, clean=SimpleNamespace(window_s=2 * 3 * flops / roofline.PEAK_BF16_FLOPS),
                          clean_counts=counts)
    readers = {m: harness.module("metrics", f"{m}.images") for m in ("conv3x3_roofline", "device_idle_pct",
                                                                      "eval_mfu_pct")}
    for reader in readers.values():
        assert reader.read(ctx) == pytest.approx(50.0, rel=1e-9)
    ctx.kernels, ctx.busy_s = [("other", 0.0, 5.0)], 0.0
    assert readers["conv3x3_roofline"].read(ctx) is None and readers["device_idle_pct"].read(ctx) is None
    ctx.kernels, ctx.busy_s, ctx.kind = kernels, 1.0, "eval"
    assert all(reader.read(ctx) is None for reader in readers.values())
