"""``layernorm_roofline.images`` on a toy trace: the bound of one launch at
the SwinIR cell's shape, two forwards of 74 counted launches at twice it
reading 50%, and nothing read from a port without the counter, a trace
without the kernel (torch's ``vectorized_layer_norm_kernel`` is not it), or
any other kind of cell."""

from types import SimpleNamespace

import pytest

from esr_bench import harness, program
from esr_tpu_torch.utils.profiler import Span

CELL = "swinir_eval_div2k_b4"
LR_SHAPE = (4, 339, 510)
PER_FORWARD = 74  # patch_embed.norm, norm1 and norm2 of 36 blocks, the final norm
KERNEL = "(anonymous namespace)::layernorm_kernel((anonymous namespace)::LnArgs)"


def _roots(n, counts):
    return [Span(i, "eval.forward", 1000 * i, 1000 * i + 500, -1, i, False, dict(counts)) for i in range(n)]


def _ctx(kernels):
    cfg = harness.load("configs", harness.load("workloads", CELL)["config"])
    return SimpleNamespace(kind="images", cfg=cfg, units=2, kernels=kernels,
                           counts={"forwards": 2, "lr_shape": LR_SHAPE})


def test_bound_of_one_launch():
    """704,512 tokens of 180 bf16 channels, read and written once: 507 MB,
    0.151 ms at 3.35 TB/s."""
    reader = harness.module("metrics", "layernorm_roofline.images")
    cfg = _ctx([]).cfg
    assert round(reader.bound_s(cfg, *LR_SHAPE) * 1e3, 3) == 0.151
    assert reader.bound_s(cfg, 1, 8, 8) == pytest.approx(64 * 4 * 180 / 3.35e12, rel=1e-12)


def test_reader_on_a_toy_trace(monkeypatch):
    reader = harness.module("metrics", "layernorm_roofline.images")
    bound_ms = reader.bound_s(_ctx([]).cfg, *LR_SHAPE) * 1e3
    kernels = [(KERNEL, 10.0 * i, 2e3 * bound_ms) for i in range(2 * PER_FORWARD)]
    kernels += [("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float>(...)",
                 0.0, 900.0), ("other", 0.0, 50.0)]
    earlier = _roots(2, {"layernorm": PER_FORWARD})  # the warm units before the window
    monkeypatch.setattr(program, "spans", lambda: earlier + _roots(2, {"layernorm": PER_FORWARD}))
    ctx = _ctx(kernels)
    assert reader.read(ctx) == pytest.approx(50.0, rel=1e-9)
    # the parent: torch's LayerNorm, no counter
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {"window_attn": 36}))
    assert reader.read(_ctx(kernels[2 * PER_FORWARD:])) is None
    assert reader.read(ctx) is None
    monkeypatch.setattr(program, "spans", lambda: None)
    assert reader.read(ctx) is None
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {"layernorm": PER_FORWARD}))
    assert reader.read(_ctx(kernels[2 * PER_FORWARD:])) is None
    ctx.kind = "eval"
    assert reader.read(ctx) is None
