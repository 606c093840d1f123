"""``linear_roofline.images`` on a toy trace: the bound's arithmetic at the
SwinIR cell's shape (5,040 bytes and 518,400 FLOP a padded token and block,
38.2 ms of bytes a forward), two forwards of 144 counted launches at twice
their bound reading 50%, and nothing read from a port without the counter,
a trace without the kernel (cuBLAS's GEMMs are not it), or any other kind
of cell."""

from types import SimpleNamespace

import pytest

from esr_bench import harness, program, roofline
from esr_tpu_torch.utils.profiler import Span

CELL = "swinir_eval_div2k_b4"
LR_SHAPE = (4, 339, 510)
PER_FORWARD = 144  # qkv, proj, fc1 and fc2 of 36 Swin blocks
KERNEL = "void (anonymous namespace)::token_linear_kernel<180, 184, 0>((anonymous namespace)::TlArgs)"
CUBLAS = "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align2>(Params)"


def _roots(n, counts):
    return [Span(i, "eval.forward", 1000 * i, 1000 * i + 500, -1, i, False, dict(counts)) for i in range(n)]


def _ctx(kernels):
    cfg = harness.load("configs", harness.load("workloads", CELL)["config"])
    return SimpleNamespace(kind="images", cfg=cfg, units=2, kernels=kernels,
                           counts={"forwards": 2, "lr_shape": LR_SHAPE})


def test_bound_of_a_forward():
    """C 180, r 2: 28 C = 5,040 bytes and 2 (4 C^2 + 2 C 2C) = 518,400 FLOP a
    token a block, so bytes bound (103 FLOP a byte against the H100's ~295);
    36 blocks on 704,512 padded tokens (4 x 344 x 512): 38.2 ms a forward, a
    launch's share 0.265 ms (qkv's own 8 C bytes 0.303, proj's 6 C 0.227)."""
    reader = harness.module("metrics", "linear_roofline.images")
    cfg = _ctx([]).cfg
    assert reader.block_bytes(cfg) == 5040 and reader.block_flops(cfg) == 518_400
    tokens = 4 * 344 * 512
    block = reader.block_bound_s(cfg, *LR_SHAPE)
    assert block == pytest.approx(5040 * tokens / roofline.PEAK_BYTES_PER_S, rel=1e-12)
    assert round(36 * block * 1e3, 1) == 38.2
    assert round(block / 4 * 1e3, 3) == 0.265
    assert round(8 * 180 * tokens / roofline.PEAK_BYTES_PER_S * 1e3, 3) == 0.303
    assert round(6 * 180 * tokens / roofline.PEAK_BYTES_PER_S * 1e3, 3) == 0.227


def test_reader_on_a_toy_trace(monkeypatch):
    reader = harness.module("metrics", "linear_roofline.images")
    launch_ms = reader.block_bound_s(_ctx([]).cfg, *LR_SHAPE) / 4 * 1e3
    kernels = [(KERNEL, 10.0 * i, 2e3 * launch_ms) for i in range(2 * PER_FORWARD)]
    kernels += [(CUBLAS, 0.0, 3000.0), ("other", 0.0, 50.0)]
    earlier = _roots(2, {"token_linear": PER_FORWARD})  # the warm units before the window
    monkeypatch.setattr(program, "spans", lambda: earlier + _roots(2, {"token_linear": PER_FORWARD}))
    ctx = _ctx(kernels)
    assert reader.read(ctx) == pytest.approx(50.0, rel=1e-9)
    # the parent: cuBLAS's GEMMs, no counter
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {"window_attn": 36, "layernorm": 74}))
    assert reader.read(_ctx(kernels[2 * PER_FORWARD:])) is None
    assert reader.read(ctx) is None
    monkeypatch.setattr(program, "spans", lambda: None)
    assert reader.read(ctx) is None
    monkeypatch.setattr(program, "spans", lambda: _roots(2, {"token_linear": PER_FORWARD}))
    assert reader.read(_ctx(kernels[2 * PER_FORWARD:])) is None
    ctx.kind = "eval"
    assert reader.read(ctx) is None
