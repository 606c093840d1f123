"""HAT behind the CEM (``hat_eval_div2k_b4``, kind ``hat``) and the
explorable RRDB on one LR 64^2 crop (``esr_eval_b1_lr64``, kind ``eval``),
run on the CPU at a toy size of their own (``toy_cells``: HAT at embed 12,
2 heads, window 4 (key window 6), compress 3, squeeze 4, depths [2, 2], LR
10 x 13, which the window pads to 12 x 16, so that both shifts, the mask
and the OCAB's zero keys occur; the RRDB at nf 8, nb 1, gc 4, LR 16); the
control and each planted fault failing the check; the hand counts of
``roofline_hat.py``; the eight ``.hat`` readers on a toy trace, and nothing
read on any other kind."""

import copy
from types import SimpleNamespace

import pytest

from esr_bench import harness, program, roofline, roofline_hat
from esr_bench.traffic import hat
from esr_tpu_torch.utils.profiler import Span

SEED = 2**33 + 24242
CELLS = ["hat_eval_div2k_b4", "esr_eval_b1_lr64"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
HAT_READERS = ("hab_attn_roofline.hat", "oca_attn_roofline.hat", "channel_attn_roofline.hat", "conv3x3_roofline.hat",
               "eval_mfu_pct.hat", "linear_roofline.hat", "layernorm_roofline.hat", "device_idle_pct.hat")


def shrink(kind: str, data: dict) -> dict:
    """The cells' configurations and mixes at a size the CPU runs in seconds,
    in float32. The HAT cell's ``sr_rel_err`` limit is 1% there: in f32 the
    port's plain path meets the reference to ~1e-6, and at two groups of
    two blocks the control and the weakest fault move the answer by 5-10%,
    inside the card's bf16 limit, which is set for 36 blocks in bf16."""
    d = copy.deepcopy(data)
    if kind == "workloads" and d["config"] == "hat_srx4_imagenet":
        d["limits"] = dict(d["limits"], sr_rel_err=0.01)
    if kind == "configs":
        d["bf16"] = False
        if d["network_G"]["which_model_G"] == "HAT":
            d["network_G"].update(embed_dim=12, depths=[2, 2], num_heads=[2, 2], window_size=4, squeeze_factor=4)
        else:
            d["network_G"].update(nf=8, nb=1, gc=4)
    elif kind == "traffic" and d["kind"] == "hat":
        d.update(images=2, lr_h=10, lr_w=13, pool=2, trace_seconds=0.3)
    elif kind == "traffic" and d["kind"] == "eval":  # one batch: a short window on a busy CPU still answers it
        d.update(lr_size=16, pool=1, trace_seconds=0.3)
    return d


@pytest.fixture
def toy_cells(monkeypatch):
    real = harness.load
    monkeypatch.setattr(harness, "load", lambda kind, name: shrink(kind, real(kind, name)))


def run(cell, trace=False):
    return harness.run(cell, SEED, 0.3, trace, "cpu", 0.0)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(toy_cells, cell, trace):
    out = run(cell, trace)
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == {"sr_rel_err", "cem_residual"}
    if not trace:
        assert set(out["metrics"]) == {"eval_hr_mp_per_s", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check_at_toy_size(toy_cells, cell):
    bench = harness.Bench(cell, SEED, "cpu", False)
    traffic = harness.module("traffic", bench.kind).Traffic(bench)
    traffic.setup()
    harness._window(traffic, 0.2)
    traffic.release()
    assert all(v <= lim for _, v, lim in traffic.judge())
    assert any(v > lim for _, v, lim in traffic.control())


@pytest.fixture(scope="module")
def toy_faults():
    """``faults()`` of the toy HAT cell, computed once: {fault: checks}."""
    mp = pytest.MonkeyPatch()
    real = harness.load
    mp.setattr(harness, "load", lambda kind, name: shrink(kind, real(kind, name)))
    try:
        traffic = hat.Traffic(harness.Bench("hat_eval_div2k_b4", SEED, "cpu", False))
        traffic.setup()
        return traffic.faults()
    finally:
        mp.undo()


@pytest.mark.parametrize("fault", hat.FAULTS)
def test_a_planted_fault_fails_the_check(toy_faults, fault):
    """Each fault planted in the port (``faults()``, what ``calibrate.py``
    reads) fails ``sr_rel_err``."""
    checks = dict((n, v > lim) for n, v, lim in toy_faults[fault])
    assert checks["sr_rel_err"], toy_faults[fault]


@pytest.mark.parametrize("fault", hat.FAULTS)
def test_a_planted_fault_fails_a_whole_run(toy_cells, monkeypatch, fault):
    """The same fault planted under a whole run: ``correct`` is false."""
    from esr_tpu_torch.models import blocks

    name, planted = hat.plant(fault)
    monkeypatch.setattr(blocks, name, planted)
    out = run("hat_eval_div2k_b4")
    assert out["correct"] is False and out["checks"]["sr_rel_err"]["value"] > out["checks"]["sr_rel_err"]["limit"]


def test_the_planted_functions_without_their_fault_are_the_ports():
    """The faulty functions compute the port's plain attention and residual
    but for the fault: at shift 0 the HAB's, with no key masked the OCAB's
    (a name that plants no fault) and the CAB's at scale 0; each OCAB fault
    moves the answer."""
    import torch

    from esr_tpu_torch.ops.cuda import channel_attn, hat_attn

    g = torch.Generator().manual_seed(0)
    qkv, table = torch.randn(2, 8, 12, 36, generator=g), torch.randn(2, 49, generator=g)
    torch.testing.assert_close(hat.faulty_hab(qkv, table, 2, 4, 2),
                               hat_attn.hab_attention_reference(qkv, table, 2, 4, 0))
    assert not torch.allclose(hat.faulty_hab(qkv, table, 2, 4, 2),
                              hat_attn.hab_attention_reference(qkv, table, 2, 4, 2))
    table = torch.randn(2, 81, generator=g)
    want = hat_attn.oca_attention_reference(qkv, table, 2, 4, 6)
    torch.testing.assert_close(hat.faulty_oca("none")(qkv, table, 2, 4, 6), want)
    for fault in ("oca_keys_cut", "oca_edge_masked"):
        assert (hat.faulty_oca(fault)(qkv, table, 2, 4, 6) - want).abs().max() > 0.05
    cx, u = torch.randn(2, 3, 4, 16, generator=g), torch.randn(2, 3, 4, 12, generator=g)
    w1, b1, w2, b2 = torch.randn(3, 12), torch.randn(3), torch.randn(12, 3), torch.randn(12)
    torch.testing.assert_close(hat.faulty_channel_attention("ca_dropped")(cx, u, w1, b1, w2, b2, 0.0),
                               channel_attn.channel_attention_reference(cx, u, w1, b1, w2, b2, 0.0))


def test_hand_counts():
    """25,361,388 MACs a padded LR pixel, its split as the issue's table,
    and each new launch's bound at the cell's B4 x 352 x 512."""
    cfg = harness.load("configs", "hat_srx4_imagenet")
    assert roofline_hat.macs_per_pixel(cfg) == 25_361_388
    assert roofline_hat.padded(cfg, 339, 510) == (352, 512)
    assert round(roofline_hat.model_flops(cfg, 4, 339, 510) / 1e12, 2) == 36.57
    assert roofline_hat.attention_bytes(cfg, 1, 1, 1) / 256 == 1_440  # a token: q, k, v in, o out, bf16
    assert roofline_hat.attention_flops(cfg, 1, 16, 16, 256) / 256 == 184_320
    assert roofline_hat.attention_flops(cfg, 1, 16, 16, 576) / 256 == 414_720
    hab = roofline_hat.attention_bound_s(cfg, 4, 339, 510, oca=False)
    oca = roofline_hat.attention_bound_s(cfg, 4, 339, 510, oca=True)
    ca = roofline_hat.channel_attn_bound_s(cfg, 4, 339, 510)
    assert round(hab * 1e3, 4) == round(oca * 1e3, 4) == 0.3099  # both bound by bytes: 1.038 GB at 3.35 TB/s
    assert round(ca * 1e3, 4) == 0.2324  # cx and u read, r written once: 0.779 GB at 3.35 TB/s
    sites = roofline_hat.generator_convs(cfg, 4, 339, 510)
    assert len(sites) == 84 and sites[1].site.endswith("cab.0") and {c.kernel for c in sites} == {"conv_tc_kernel"}
    assert round(sum(roofline.bound_s(c.kernel_flops, c.bytes) for c in sites) * 1e3, 2) == 14.94


def test_conv_sites_and_the_rest_are_the_forward():
    """The 84 conv sites' FLOPs plus the linears' and attentions' are the whole forward's."""
    cfg = harness.load("configs", "hat_srx4_imagenet")
    g = cfg["network_G"]
    c, hidden = g["embed_dim"], 2 * g["embed_dim"]
    px = 4.0 * 352 * 512
    linears = 42 * (c * 3 * c + c * c + 2 * c * hidden)
    attn = 36 * 2 * 256 * c + 6 * 2 * 576 * c
    convs = sum(s.model_flops for s in roofline_hat.generator_convs(cfg, 4, 339, 510))
    assert convs + 2 * (linears + attn) * px == pytest.approx(roofline_hat.model_flops(cfg, 4, 339, 510), rel=1e-12)


def _roots(n, counts):
    return [Span(i, "eval.forward", 1000 * i, 1000 * i + 500, -1, i, False, dict(counts)) for i in range(n)]


@pytest.mark.parametrize("metric,counter,kernel,per,bound", [
    ("hab_attn_roofline.hat", "hab_attn", "void {anonymous}::hat_attn_kernel<16>(HatAttnArgs)", 36,
     lambda cfg, s: roofline_hat.attention_bound_s(cfg, *s, oca=False)),
    ("oca_attn_roofline.hat", "oca_attn", "void {anonymous}::hat_attn_kernel<24>(HatAttnArgs)", 6,
     lambda cfg, s: roofline_hat.attention_bound_s(cfg, *s, oca=True)),
    ("channel_attn_roofline.hat", "channel_attn", "{anonymous}::ca_pool_kernel(PoolArgs)", 36,
     lambda cfg, s: roofline_hat.channel_attn_bound_s(cfg, *s)),
    ("linear_roofline.hat", "token_linear", "void {anonymous}::token_linear_kernel<180, 540, 0>(LinearArgs)", 168,
     lambda cfg, s: harness.module("metrics", "linear_roofline.hat").block_bound_s(cfg, *s) / 4),
    ("layernorm_roofline.hat", "layernorm", "void {anonymous}::layernorm_kernel<180>(LayerNormArgs)", 86,
     lambda cfg, s: harness.module("metrics", "layernorm_roofline.hat").bound_s(cfg, *s)),
])
def test_counted_readers_on_a_toy_trace(monkeypatch, metric, counter, kernel, per, bound):
    """Two forwards' launches counted on their roots, the trace's records of
    the kernel at twice the bound each: 50%. A port without the counter, or
    a trace without the kernel, reads nothing; so does every other kind."""
    reader = harness.module("metrics", metric)
    cfg = harness.load("configs", "hat_srx4_imagenet")
    lr_shape = (4, 339, 510)
    bound_ms = bound(cfg, lr_shape) * 1e3
    kernels = [(kernel, 10.0 * i, 2e3 * bound_ms) for i in range(2 * per)] + [("other", 0.0, 50.0)]
    if counter == "hab_attn":  # the OCAB's launches are not the HABs'
        kernels.append(("void {anonymous}::hat_attn_kernel<24>(HatAttnArgs)", 0.0, 1e6))
    earlier = _roots(2, {counter: per})  # the warm units before the window
    monkeypatch.setattr(program, "spans", lambda: earlier + _roots(2, {counter: per}))
    ctx = SimpleNamespace(kind="hat", cfg=cfg, units=2, kernels=kernels, counts={"forwards": 2, "lr_shape": lr_shape})
    assert reader.read(ctx) == pytest.approx(50.0, rel=1e-9)
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {}))
    assert reader.read(ctx) is None
    monkeypatch.setattr(program, "spans", lambda: None)
    assert reader.read(ctx) is None
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {counter: per}))
    assert reader.read(SimpleNamespace(**{**vars(ctx), "kernels": [("other", 0.0, 5.0)]})) is None
    for kind in ("images", "eval", "train", "clicks"):
        assert reader.read(SimpleNamespace(**{**vars(ctx), "kind": kind})) is None


def test_whole_forward_readers_on_a_toy_trace():
    """``conv_tc_kernel``'s records of two forwards (the GELU instance's
    among them) at twice their summed bound read 50%; the untraced window's
    forwards in twice their time at the peak, 50% MFU. A trace without the
    kernel reads nothing; nor does any other kind of cell."""
    cfg = harness.load("configs", "hat_srx4_imagenet")
    lr_shape = (4, 339, 510)
    sites = roofline_hat.generator_convs(cfg, *lr_shape)
    names = ["void esr::conv_tc_kernel_gelu<64, 4, false, 3, false>(...)" if ".cab.0" in c.site else
             "void esr::conv_tc_kernel<64, 4, false, 3, true>(...)" for c in sites]
    kernels = [(n, 10.0 * i, 2e6 * roofline.bound_s(c.kernel_flops, c.bytes)) for i, (n, c) in
               enumerate(zip(2 * names, 2 * sites))]
    counts = {"forwards": 3, "lr_shape": lr_shape}
    ctx = SimpleNamespace(kind="hat", cfg=cfg, counts=counts, kernels=kernels + [("other", 0.0, 5.0)],
                          clean=SimpleNamespace(window_s=2 * 3 * roofline_hat.model_flops(cfg, *lr_shape)
                                                / roofline.PEAK_BF16_FLOPS), clean_counts=counts)
    readers = {m: harness.module("metrics", m) for m in ("conv3x3_roofline.hat", "eval_mfu_pct.hat")}
    for reader in readers.values():
        assert reader.read(ctx) == pytest.approx(50.0, rel=1e-9)
    ctx.kernels = [("other", 0.0, 5.0)]
    assert readers["conv3x3_roofline.hat"].read(ctx) is None
    ctx.kernels = kernels
    for kind in ("images", "eval", "train", "clicks"):
        ctx.kind = kind
        assert all(reader.read(ctx) is None for reader in readers.values())


def test_other_readers_read_nothing_on_a_hat_cell(monkeypatch):
    """Every reader that is not ``.hat`` returns None on a ``hat`` cell's trace."""
    cfg = harness.load("configs", "hat_srx4_imagenet")
    counts = {"forwards": 2, "lr_shape": (4, 339, 510), "steps": 2, "clicks": 2, "z_steps": 2}
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {"window_attn": 36, "layernorm": 86, "token_linear": 168,
                                                             "rdb5c": 69, "hab_attn": 36}))
    ctx = SimpleNamespace(kind="hat", cfg=cfg, mix={}, units=2, kernels=[("conv_tc_kernel", 0.0, 5.0)], busy=[],
                          spans=[], busy_s=1.0, window_s=2.0, counts=counts,
                          clean=SimpleNamespace(units=2, window_s=1.0), clean_counts=counts)
    for path in sorted((harness.BENCH / "metrics").glob("*.py")):
        if path.stem not in HAT_READERS:
            assert harness.module("metrics", path.stem).read(ctx) is None, path.stem


def test_idle_reader_on_a_toy_trace():
    """A ``hat`` cell's window busy for 1.5 s of 2 reads 25% idle; a trace
    with no device work, or any other kind of cell, reads nothing."""
    reader = harness.module("metrics", "device_idle_pct.hat")
    ctx = SimpleNamespace(kind="hat", busy_s=1.5, window_s=2.0)
    assert reader.read(ctx) == pytest.approx(25.0, rel=1e-12)
    assert reader.read(SimpleNamespace(kind="hat", busy_s=0.0, window_s=2.0)) is None
    for kind in ("images", "eval", "train", "clicks"):
        assert reader.read(SimpleNamespace(kind=kind, busy_s=1.5, window_s=2.0)) is None
