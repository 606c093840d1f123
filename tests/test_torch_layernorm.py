"""The port's LayerNorm (``ops/cuda/layernorm.py``, ``csrc/layernorm.cu``),
which SwinIR's ``models/blocks.py::LayerNorm`` calls.

CPU: ``LayerNorm`` is ``F.layer_norm`` bit for bit (f32 and bf16), so
SwinIR's plain forward is unchanged; the wrapper's refusals; a mirror of the
kernel's partition of rows into runs, warps and blocks (every row covered
once, every run 16-byte aligned, the chunks and half chunks of a run tiling
its elements) and of its arithmetic, against ``F.layer_norm``.

Card (skip without one; run as ``tests/torch_card.py`` says): the kernel
against an f32 reference at the ``swinir_eval_div2k_b4`` cell's shape and
at ragged row counts, within one bf16 ulp of the reference's rounding, as
torch's own bf16 kernel is; one launch counted a call; a CUDA graph's
replay equal to an eager call; at serving sizes no slower than torch's.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from esr_tpu_torch.models import blocks
from esr_tpu_torch.models.networks import define_G
from esr_tpu_torch.ops.cuda import layernorm
from test_torch_swinir import M, TOY, seeded_state
from torch_card import cuda  # noqa: F401

EPS = 1e-5


def _inputs(shape, seed, device="cpu", spread=True):
    """bf16 rows off zero and of spread scale (else all of scale 2), and
    weights near 1 and 0, as a trained transformer's LayerNorm sees them."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=device)
    x = x * (0.5 + torch.rand(shape[:-1] + (1,), generator=g, device=device) * 4 if spread else 2) + 0.3
    w = 1 + 0.2 * torch.randn(c, generator=g, device=device)
    b = 0.1 * torch.randn(c, generator=g, device=device)
    return x.bfloat16(), w.bfloat16(), b.bfloat16()


# -- the CPU path ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_on_the_cpu_is_f_layer_norm_bit_for_bit(dtype):
    ln = blocks.LayerNorm(180)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.2 * torch.randn(180, generator=torch.Generator().manual_seed(1)))
        ln.bias.copy_(0.1 * torch.randn(180, generator=torch.Generator().manual_seed(2)))
    x = torch.randn(2, 5, 7, 180, generator=torch.Generator().manual_seed(3)).to(dtype)
    want = F.layer_norm(x, (180,), ln.weight.to(dtype), ln.bias.to(dtype), 1e-5)
    assert torch.equal(ln(x), want)
    with torch.no_grad():
        assert torch.equal(ln(x), want)


def test_swinir_plain_forward_is_unchanged(monkeypatch):
    """The toy SwinIR's forward with ``LayerNorm`` through ``layer_norm`` is
    the forward with ``F.layer_norm`` called as before, bit for bit; it runs
    2 + 2 x (blocks) LayerNorms, and SwinIR-M builds 74."""
    g = define_G(TOY, device="cpu")
    g.load_state_dict(seeded_state(TOY, seed=5), strict=True)
    lr = torch.rand(1, 10, 13, 3, generator=torch.Generator().manual_seed(5))
    calls = []
    real = blocks.layer_norm
    monkeypatch.setattr(blocks, "layer_norm", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = g(lr)
    assert len(calls) == 2 + 2 * sum(TOY["network_G"]["depths"])
    monkeypatch.setattr(blocks.LayerNorm, "forward",
                        lambda self, x: F.layer_norm(x, x.shape[-1:], *self._weights(x), self.eps))
    with torch.no_grad():
        assert torch.equal(got, g(lr))
    big = define_G(M, device="cpu")
    assert sum(isinstance(m, blocks.LayerNorm) for m in big.modules()) == 74


@pytest.mark.parametrize("x_shape,w_shape,dtype,grad,error,match", [
    ((3, 180), (180,), torch.bfloat16, False, RuntimeError, "no kernel for device cpu"),
    ((3, 180), (180,), torch.float32, False, ValueError, "bf16 rows of C channels"),
    ((3, 182), (182,), torch.bfloat16, False, ValueError, "a multiple of 4"),
    ((3, 260), (260,), torch.bfloat16, False, ValueError, "a multiple of 4 in \\[4, 256\\]"),
    ((3, 180), (179,), torch.bfloat16, False, ValueError, "weight \\(180,\\) bf16"),
    ((3, 180), (180,), torch.bfloat16, True, RuntimeError, "forward-only"),
])
def test_the_launch_refuses(x_shape, w_shape, dtype, grad, error, match):
    """What the kernel does not take raises, before any launch and without
    counting one: a CPU tensor, a dtype other than bf16, a width not a
    multiple of 4 or above 256, a weight of another shape, an input autograd
    tracks."""
    x = torch.zeros(x_shape, dtype=dtype, requires_grad=grad)
    w = torch.ones(w_shape, dtype=torch.bfloat16)
    before = layernorm.LAUNCHES.count
    with pytest.raises(error, match=match):
        layernorm.layer_norm_launch(x, w, torch.zeros(x_shape[-1], dtype=torch.bfloat16), EPS)
    assert layernorm.LAUNCHES.count == before


def test_a_weight_on_another_device_is_refused():
    x = torch.zeros(3, 180, dtype=torch.bfloat16)
    w = torch.ones(180, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="bias \\(180,\\) bf16 on cpu expected"):
        layernorm.layer_norm_launch(x, torch.ones(180, dtype=torch.bfloat16), w, EPS)


# -- the kernel's partition, mirrored ---------------------------------------------

RUN_ROWS = 2  # rows a run: 4 C bytes, 16-byte aligned for C a multiple of 4
KERNEL_RUNS = 4  # runs a warp's stage (kRuns)
KERNEL_WARPS = 8  # warps a block (kWarps)


def kernel_grid(rows, sms, per_sm):
    """``esr_layernorm``'s grid: a block a warps x runs-a-warp runs, at most
    the blocks the SMs hold."""
    runs = -(-rows // RUN_ROWS)
    return min(-(-runs // (KERNEL_WARPS * KERNEL_RUNS)), sms * per_sm)


def kernel_runs(rows, blocks):
    """The runs each warp of ``layernorm_kernel`` takes, in order: warp w's
    loop starts at run w x kRuns and steps by the grid's warps x kRuns; each
    step takes kRuns consecutive runs (those at or past the last run load
    and store nothing). Returns every run a step takes before the last
    run's end, warp by warp."""
    runs = -(-rows // RUN_ROWS)
    warps = blocks * KERNEL_WARPS
    step = warps * KERNEL_RUNS
    w = torch.arange(warps)
    r0 = w[:, None] * KERNEL_RUNS + torch.arange(-(-runs // step) + 1)[None, :] * step
    r = (r0[:, :, None] + torch.arange(KERNEL_RUNS)).reshape(warps, -1)
    r = torch.where(r0.repeat_interleave(KERNEL_RUNS, 1) < runs, r, -1)
    return r[(r >= 0) & (r < runs)]


def run_pieces(c, rows_in_run):
    """A run's 16-byte chunks by lane (chunk lane + 32 j), as the kernel
    loads them: (first element, elements) of each chunk or half chunk that
    lies in the run's rows, and each 8-byte half's (row, first channel)."""
    chunks = c // 4
    assert chunks <= 64  # two chunks a lane
    pieces, halves = [], []
    elems = rows_in_run * c
    for j in range(2):
        for lane in range(32):
            k = lane + 32 * j
            if k >= chunks:
                continue
            e = 8 * k
            if e + 8 <= elems:
                pieces.append((e, 8))
            elif e < elems:
                pieces.append((e, 4))
            for s in range(2):
                h = e + 4 * s
                row1 = h >= c
                halves.append((h, int(row1), h - c if row1 else h))
    return pieces, halves


@pytest.mark.parametrize("rows", [1, 2, 3, 7, 63, 64, 65, 4097, 704_512])
def test_every_row_is_taken_once_and_every_run_is_aligned(rows):
    """At C 180 (a row 360 bytes, a run 720 = 45 chunks): each row lies in
    exactly one run that exactly one warp takes once, at grids of one block
    an SM and three, and the kernel's own for a short input; every run
    starts 16-byte aligned; a full run's chunks tile its 360 elements, and
    the last run of an odd row count (one row) is tiled by 22 chunks and one
    half chunk."""
    c = 180
    for per_sm in (1, 3):
        blocks = kernel_grid(rows, 132, per_sm)
        r = kernel_runs(rows, blocks)
        row_ids = torch.cat([2 * r, 2 * r + 1])
        row_ids = row_ids[row_ids < rows]
        assert torch.equal(torch.bincount(row_ids, minlength=rows), torch.ones(rows, dtype=torch.long))
        assert not bool(((r * 2 * c * 2) % 16).any())
    for rows_in_run in (2, 1) if rows % 2 else (2,):
        pieces, _ = run_pieces(c, rows_in_run)
        covered = torch.zeros(rows_in_run * c, dtype=torch.long)
        for e, n in pieces:
            assert (2 * e) % 16 == 0
            covered[e:e + n] += 1
        assert torch.equal(covered, torch.ones_like(covered))
        assert len(pieces) == (45 if rows_in_run == 2 else 23)


@pytest.mark.parametrize("c", [4, 12, 60, 180, 240, 256])
def test_a_run_halves_fall_in_one_row_each(c):
    """Every 8-byte half of a run's chunks holds 4 channels of one row: the
    halves cover each (row, channel) of the two rows once, and a run is a
    whole number of chunks."""
    assert (2 * 2 * c) % 16 == 0
    _, halves = run_pieces(c, 2)
    seen = torch.zeros(2, c, dtype=torch.long)
    for _, row, ch in halves:
        assert 0 <= ch and ch + 4 <= c
        seen[row, ch:ch + 4] += 1
    assert torch.equal(seen, torch.ones_like(seen))


def emulate(x, w, b, eps):
    """``layernorm_kernel``'s arithmetic on its partition: per run, each
    lane's halves summed into their row's sum, the warp's sums over C the
    mean, the centred squares of the lanes' halves the variance, rsqrt,
    then ``w * (rstd * (x - mean)) + b`` per half, rounded to bf16."""
    c = x.shape[-1]
    flat = x.reshape(-1).float()
    rows = flat.numel() // c
    out = torch.empty_like(flat)
    _, halves = run_pieces(c, 2)
    for r in range(-(-rows // 2)):
        base = 2 * r * c
        sums, sq = [0.0, 0.0], [0.0, 0.0]
        for h, row, _ in halves:
            if base + h < flat.numel():
                sums[row] += float(flat[base + h:base + h + 4].sum())
        means = [s / c for s in sums]
        for h, row, _ in halves:
            if base + h < flat.numel():
                sq[row] += float(((flat[base + h:base + h + 4] - means[row]) ** 2).sum())
        rstd = [1 / math.sqrt(q / c + eps) for q in sq]
        for h, row, ch in halves:
            if base + h < flat.numel():
                v = flat[base + h:base + h + 4]
                wh, bh = w[ch:ch + 4].float(), b[ch:ch + 4].float()
                out[base + h:base + h + 4] = wh * (rstd[row] * (v - means[row])) + bh
    return out.reshape(x.shape).bfloat16()


# Outputs nearer zero than this are the difference of O(1) terms (w x-hat
# and b), and carry their f32 rounding, ~1e-7, which is more than bf16's
# spacing there: the ulp is taken at this magnitude at least.
ULP_FLOOR = 2.0**-12


def bf16_ulp(t):
    """The spacing of bf16 values (8 significant bits) at each of ``t``'s
    magnitudes, or at ``ULP_FLOOR`` for those below it."""
    _, e = torch.frexp(t.float().abs().clamp(min=ULP_FLOOR))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def within_one_ulp(got, ref):
    return bool(((got.float() - ref.float()).abs() <= bf16_ulp(ref)).all())


@pytest.mark.parametrize("shape", [(1, 180), (3, 180), (2, 3, 60), (5, 240), (3, 4)])
def test_the_kernels_arithmetic_mirrored_is_layer_norm(shape):
    """The mirror of the kernel's arithmetic on its halves, ragged row counts
    included, within one bf16 ulp of the f32 reference's rounding."""
    x, w, b = _inputs(shape, seed=sum(shape))
    ref = F.layer_norm(x.float(), shape[-1:], w.float(), b.float(), EPS).bfloat16()
    assert within_one_ulp(emulate(x, w, b, EPS), ref)


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spread", [((4, 344, 512, 180), True), ((1, 180), True), ((3, 180), True),
                                          ((4097, 180), True), ((7, 9, 60), True), ((65, 240), True),
                                          ((5, 256), True), ((3, 4), True), ((4, 344, 512, 180), False)])
def test_cuda_layer_norm_matches_the_f32_reference(cuda, shape, spread):
    """At the SwinIR cell's shape (704,512 tokens of 180; rows of spread
    scale, and all of scale 2) and at ragged row counts and SwinIR's other
    widths: one launch counted, within one bf16 ulp of the f32 reference's
    rounding (F.layer_norm on the bf16 input and weights upcast, rounded to
    bf16), as torch's own bf16 F.layer_norm is (the ulp taken at 2^-12 at
    least: ``ULP_FLOOR``)."""
    x, w, b = _inputs(shape, seed=len(shape) + shape[0] + (not spread), device=cuda, spread=spread)
    before = layernorm.LAUNCHES.count
    with torch.no_grad():
        got = layernorm.layer_norm(x, w, b, EPS)
    torch.cuda.synchronize()
    assert layernorm.LAUNCHES.count == before + 1
    ref = F.layer_norm(x.float(), shape[-1:], w.float(), b.float(), EPS).bfloat16()
    torch_bf16 = F.layer_norm(x, shape[-1:], w, b, EPS)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert within_one_ulp(torch_bf16, ref)
    assert within_one_ulp(got, ref)


@pytest.mark.cuda
def test_cuda_layer_norm_is_no_further_from_exact_than_torchs(cuda):
    """At the cell's shape, against LayerNorm in f64 rounded to bf16: the
    kernel's answer differs in no more values than torch's bf16 kernel's
    (torch's f32 reference shares that kernel's statistics to the bit, so
    only an f64 one can rank the two)."""
    x, w, b = _inputs((4, 344, 512, 180), seed=21, device=cuda)
    with torch.no_grad():
        got = layernorm.layer_norm(x, w, b, EPS)
    exact = F.layer_norm(x.double(), (180,), w.double(), b.double(), EPS).bfloat16()
    torch_bf16 = F.layer_norm(x, (180,), w, b, EPS)
    assert int((got != exact).sum()) <= int((torch_bf16 != exact).sum())


@pytest.mark.cuda
def test_cuda_layer_norm_replays_in_a_graph(cuda):
    """Captured in a CUDA graph and replayed on new input, the kernel gives
    what an eager call gives, bit for bit: it launches on the current
    stream and allocates nothing."""
    x, w, b = _inputs((2, 64, 96, 180), seed=11, device=cuda)
    x2, _, _ = _inputs((2, 64, 96, 180), seed=12, device=cuda)
    with torch.no_grad():
        layernorm.layer_norm(x, w, b, EPS)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            layernorm.layer_norm(x, w, b, EPS)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = layernorm.layer_norm(x, w, b, EPS)
        x.copy_(x2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, layernorm.layer_norm(x2, w, b, EPS))


@pytest.mark.cuda
@pytest.mark.parametrize("side", [64, 128])
def test_cuda_layer_norm_no_slower_than_torchs_at_serving_sizes(cuda, side):
    """At serving sizes (B1 x 64^2 and 128^2 tokens of 180), 50 launches in
    a CUDA graph as a served forward runs them: the kernel's device time no
    more than torch's bf16 F.layer_norm's (CUDA events, median of 5
    replays)."""
    from esr_tpu_torch.ops.cuda.conv_bench import graph_ms

    x, w, b = _inputs((1, side, side, 180), seed=side, device=cuda, spread=False)
    with torch.no_grad():
        ms = graph_ms(lambda: layernorm.layer_norm(x, w, b, EPS), reps=50)
        lib_ms = graph_ms(lambda: F.layer_norm(x, (180,), w, b, EPS), reps=50)
    assert ms <= lib_ms, (ms, lib_ms)
