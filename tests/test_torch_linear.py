"""The port's token-wise linear with its epilogue (``ops/cuda/token_linear.py``,
``csrc/token_linear.cu``), which SwinIR's ``models/blocks.py::Linear`` calls.

CPU: the wrapper takes the plain version for a CPU tensor, and the plain
version is ``F.linear`` / ``F.gelu`` / ``+`` as SwinIR's blocks composed them,
so a Swin block's and the toy SwinIR's CPU forwards are unchanged bit for
bit; the wrapper's refusals; the weight image decoded as the kernel's wgmma
descriptors read it; a mirror of the kernel's arithmetic (slabs, padded K,
the masked columns, the f32 epilogue and its one rounding) and of its tile
walk (every (tile, slab) once, the blocks of a group on the same tiles) and
its shared-memory plan.

Card (skip without one; run as ``tests/torch_card.py`` says): each of
SwinIR-M's four sites at the ``swinir_eval_div2k_b4`` cell's 704,512 tokens
and at ragged row counts against the f32 composition rounded once, and no
farther from the f64 answer than torch's bf16 chain; a CUDA graph's replay
equal to an eager call; at serving sizes no slower than the chain.
"""

import pytest
import torch
import torch.nn.functional as F

from esr_tpu_torch.models import blocks
from esr_tpu_torch.models.networks import define_G
from esr_tpu_torch.ops.cuda import token_linear as tl
from test_torch_swinir import M, TOY, seeded_state
from torch_card import cuda  # noqa: F401

# (K, N, gelu, residual) of SwinIR-M's four sites: qkv, proj, fc1, fc2
SITES = {"qkv": (180, 540, False, False), "proj": (180, 180, False, True), "fc1": (180, 360, True, False),
         "fc2": (360, 180, False, True)}
CELL_TOKENS = 4 * 344 * 512  # the swinir_eval_div2k_b4 cell's padded LR tokens


def _inputs(site, rows, seed, device="cpu"):
    """bf16 tokens of unit scale, weights of 1 / sqrt(K) (outputs of unit
    scale), a bias of 0.1 and a residual of scale 2, as a Swin block's."""
    k, n, _, res = SITES[site]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device=device).bfloat16()
    w = (torch.randn(n, k, generator=g, device=device) * k**-0.5).bfloat16()
    b = (0.1 * torch.randn(n, generator=g, device=device)).bfloat16()
    r = (2 * torch.randn(rows, n, generator=g, device=device)).bfloat16() if res else None
    return x, w, b, r


def _f32_once(x, w, b, gelu, r):
    """The composition in f32 on the bf16 operands, rounded once to bf16."""
    return tl.token_linear_reference(x.float(), w.float(), b.float(), gelu, None if r is None else r.float()).bfloat16()


# -- the CPU path ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", list(SITES))
def test_the_cpu_takes_the_plain_version_which_is_the_old_composition(site, dtype):
    """On the CPU ``token_linear`` launches nothing and returns the plain
    version, which is ``F.linear``, then ``F.gelu``, then ``residual +``
    in the tokens' dtype, bit for bit."""
    k, n, gelu, _ = SITES[site]
    x, w, b, r = (t if t is None else t.to(dtype) for t in _inputs(site, 37, seed=k + n))
    before = tl.LAUNCHES.count
    got = tl.token_linear(x, w, b, gelu, r)
    assert tl.LAUNCHES.count == before
    want = F.linear(x, w, b)
    want = F.gelu(want) if gelu else want
    want = want if r is None else r + want
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(tl.token_linear_reference(x, w, b, gelu, r), want)


@pytest.mark.parametrize("width", [(12, 36), (24, 12), (7, 5)])
def test_the_cpu_runs_any_width(width):
    """Widths the kernel does not take run on the CPU (the toy SwinIR's)."""
    k, n = width
    x, w, b = torch.randn(3, 4, k), torch.randn(n, k), torch.randn(n)
    assert torch.equal(tl.token_linear(x, w, b, True), F.gelu(F.linear(x, w, b)))


def _parent_block_forward(blk, u):
    """A Swin block as its forward composed it before the kernel."""
    a = blk.attn
    qkv = F.linear(blk.norm1(u), a.qkv.weight.to(u.dtype), a.qkv.bias.to(u.dtype))
    bias = blocks.relative_bias(a.relative_position_bias_table, a.ws)
    o = blocks.window_attention(qkv, bias, a.heads, a.ws, blk.shift)
    u = u + F.linear(o, a.proj.weight.to(u.dtype), a.proj.bias.to(u.dtype))
    m = blk.mlp
    h = F.gelu(F.linear(blk.norm2(u), m.fc1.weight.to(u.dtype), m.fc1.bias.to(u.dtype)))
    return u + F.linear(h, m.fc2.weight.to(u.dtype), m.fc2.bias.to(u.dtype))


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_swin_block_on_the_cpu_is_unchanged(shift, dtype):
    """A Swin block's CPU forward (embed 12, 2 heads, window 4) equals the
    composition it had before the epilogues moved into the linears, bit for
    bit, with the linears' call sites counted: four a block."""
    blk = blocks.SwinBlock(12, 2, 4, shift, 2.0, torch.Generator().manual_seed(3)).to(dtype)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())).to(dtype))
    u = torch.randn(2, 8, 12, 12, generator=torch.Generator().manual_seed(4)).to(dtype)
    with torch.no_grad():
        assert torch.equal(blk(u), _parent_block_forward(blk, u))


def test_swinir_plain_forward_is_unchanged(monkeypatch):
    """The toy SwinIR's CPU forward equals the one with every block run as
    before, bit for bit; it makes 4 ``token_linear`` calls a block, and
    SwinIR-M builds 144 linears."""
    g = define_G(TOY, device="cpu")
    g.load_state_dict(seeded_state(TOY, seed=6), strict=True)
    lr = torch.rand(1, 10, 13, 3, generator=torch.Generator().manual_seed(6))
    calls = []
    real = blocks.token_linear
    monkeypatch.setattr(blocks, "token_linear", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = g(lr)
    assert len(calls) == 4 * sum(TOY["network_G"]["depths"])
    monkeypatch.setattr(blocks.SwinBlock, "forward", _parent_block_forward)
    with torch.no_grad():
        assert torch.equal(got, g(lr))
    assert sum(isinstance(m, blocks.Linear) for m in define_G(M, device="cpu").modules()) == 144


@pytest.mark.parametrize("site,x_shape,x_dtype,gelu,residual,grad,error,match", [
    ("qkv", (3, 180), torch.bfloat16, False, None, False, RuntimeError, "no kernel for device cpu"),
    ("qkv", (3, 180), torch.float32, False, None, False, ValueError, "bf16 tokens of 180 channels"),
    ("qkv", (3, 184), torch.bfloat16, False, None, False, ValueError, "bf16 tokens of 180 channels"),
    ("qkv", (3, 180), torch.bfloat16, True, None, False, ValueError, "takes the bias epilogue, not gelu"),
    ("fc1", (3, 180), torch.bfloat16, False, None, False, ValueError, "takes the gelu epilogue, not bias"),
    ("proj", (3, 180), torch.bfloat16, False, None, False, ValueError, "takes the residual epilogue, not bias"),
    ("fc2", (3, 360), torch.bfloat16, True, (3, 180), False, ValueError, "not gelu and residual"),
    ("fc2", (3, 360), torch.bfloat16, False, (3, 181), False, ValueError, "residual \\(3, 180\\) bf16"),
    ("fc2", (3, 360), torch.bfloat16, False, (3, 180), True, RuntimeError, "forward-only"),
])
def test_the_launch_refuses(site, x_shape, x_dtype, gelu, residual, grad, error, match):
    """What the kernel does not take raises before any launch and without
    counting one: a CPU tensor, a dtype other than bf16, another K, an
    epilogue other than the site's, a residual of another shape, an input
    autograd tracks."""
    k, n, _, _ = SITES[site]
    _, w, b, _ = _inputs(site, 1, seed=0)
    kw = tl.token_linear_weights(w, b)
    x = torch.zeros(x_shape, dtype=x_dtype, requires_grad=grad and residual is None)
    r = None if residual is None else torch.zeros(residual, dtype=torch.bfloat16, requires_grad=grad)
    before = tl.LAUNCHES.count
    with pytest.raises(error, match=match):
        tl.token_linear_launch(x, kw, gelu, r)
    assert tl.LAUNCHES.count == before


@pytest.mark.parametrize("shape", [(540, 184), (360, 360), (192, 180), (184, 360)])
def test_widths_other_than_the_sites_are_refused(shape):
    """(K, N) outside SwinIR-M's four sites raise with the list of sites;
    ``Linear.prepare_kernel`` builds no image for them (nor on the CPU)."""
    with pytest.raises(ValueError, match="SwinIR-M's \\(K, N\\) sites"):
        tl.token_linear_weights(torch.zeros(shape), torch.zeros(shape[0]))
    lin = blocks.Linear(shape[1], shape[0])
    lin.prepare_kernel(torch.bfloat16)
    assert lin.kernel_weights is None


# -- the weight image and the kernel, mirrored ---------------------------------------

KERNEL_ROWS = 64  # token rows a tile (kRows)
SMEM_MAX = 232_448  # shared memory a block may use on the H100 (kSmemMax)


def padded_stride(n):
    """``padded_stride``: the least stride of 8 modulo 16 elements, at least n."""
    return n if n % 16 == 8 else (n + 8) // 16 * 16 + 8


def warpgroups(site):
    """``Cfg::kWG``: three warpgroups a block at fc1 (GELU), two elsewhere."""
    return 3 if SITES[site][2] else 2


def kernel_plan(site):
    """The shared-memory plan of ``Cfg<K, NW, EPI>``: (x stages a warpgroup,
    residual / output row stride, bytes). The x tiles lie as in device
    memory, K values a row; proj's residual and y tiles too (whole rows),
    fc2's residual slab in rows of ``padded_stride``."""
    k, _, _, residual = SITES[site]
    wgs = warpgroups(site)
    nw = tl.SLABS[k][1]
    kp = -(-k // 16) * 16
    wbytes, bias = -(-kp // 64) * nw * 128, nw * 4
    rs = k if residual and k == 180 else padded_stride(nw)
    xbytes, rbytes = KERNEL_ROWS * k * 2, KERNEL_ROWS * rs * 2 * residual
    bars = 8 * (1 + 4 * wgs)
    sx = min(3, (SMEM_MAX - 1024 - wbytes - bias - wgs * rbytes - bars) // (wgs * xbytes))
    return sx, rs if residual else k, 1024 + wbytes + bias + wgs * (sx * xbytes + rbytes) + bars


@pytest.mark.parametrize("site,stages", [("qkv", 3), ("proj", 2), ("fc1", 2), ("fc2", 1)])
def test_shared_memory_plan(site, stages):
    """Each instance's weights, bias and its warpgroups' stages fit in a
    block's shared memory, with the stages the header note names; every
    stage starts 16-byte aligned (bulk copies); fc2's padded residual rows put
    a warp's fragment accesses (rows g and g + 8, columns 2 t + 8 j) into 32
    distinct banks, and the 4-byte A-fragment loads from rows of K values
    meet at most two to a bank."""
    k, _, _, res = SITES[site]
    sx, os_, total = kernel_plan(site)
    assert sx == stages and total <= SMEM_MAX
    assert (KERNEL_ROWS * k * 2) % 16 == 0 and (KERNEL_ROWS * os_ * 2) % 16 == 0
    if site == "fc2":
        assert sorted((g * os_ // 2 + t) % 32 for g in range(8) for t in range(4)) == list(range(32))
    banks = torch.bincount(torch.tensor([(g * k // 2 + t) % 32 for g in range(8) for t in range(4)]), minlength=32)
    assert int(banks.max()) <= 2


@pytest.mark.parametrize("k", [180, 360])
def test_a_fragments_read_the_rows_columns_and_zeros_past_k(k):
    """The kernel's A-fragment loads (``lo`` / ``hi``): over the k-steps, lane
    quad t reads columns 16 s + 2 t (+1) and + 8 of rows g and g + 8, all of
    [0, K) exactly once a row, and zeros in the columns past K (which in a
    row K values long are the next row's)."""
    steps = -(-k // 16)
    seen = torch.zeros(k + 16, dtype=torch.long)
    for s in range(steps):
        for t in range(4):
            c = 16 * s + 2 * t
            lo = 16 * s + 8 <= k or c < k
            hi = 16 * s + 16 <= k or c + 8 < k
            for col, on in ((c, lo), (c + 8, hi)):
                assert on == (col < k)
                seen[col:col + 2] += on
    assert torch.equal(seen[:k], torch.ones(k, dtype=torch.long)) and not seen[k:].any()


@pytest.mark.parametrize("k", [180, 360])
def test_tiles_move_as_bulk_copies_and_an_eight_byte_tail(k):
    """``load_rows`` / ``store_rows``: every tile starts 16-byte aligned in
    device memory, and its bytes are a bulk copy of a multiple of 16 and, for
    an odd row count at K 180 only, one 8-byte tail."""
    for rows in range(1, KERNEL_ROWS + 1):
        nbytes = rows * k * 2
        body = nbytes & ~15
        assert body > 0 and nbytes - body in ((8,) if k == 180 and rows % 2 else (0,))
    assert all(t * KERNEL_ROWS * k * 2 % 16 == 0 for t in range(64))


def decode_image(kw, slab):
    """The slab's (NW, K padded to 16) weights as the kernel reads them: k-step
    s's descriptor starts at panel s // 4, 32 (s % 4) bytes into its 128-byte
    rows, rows 128 bytes apart (8-row groups 1024), and chunk c of row n lies
    at chunk c ^ (n % 8) (the 128-byte swizzle)."""
    nw = tl.SLABS[kw.k][1]
    kp = -(-kw.k // 16) * 16
    flat = kw.image[slab].reshape(-1)
    out = torch.empty(nw, kp, dtype=flat.dtype)
    for s in range(kp // 16):
        base = (s // 4) * nw * 128 + (s % 4) * 32
        for half in range(2):
            c = (base % 128) // 16 + half
            for n in range(nw):
                at = (base - base % 128) + n * 128 + ((c ^ (n % 8)) * 16)
                out[n, 16 * s + 8 * half:16 * s + 8 * half + 8] = flat[at // 2:at // 2 + 8]
    return out


@pytest.mark.parametrize("site", list(SITES))
def test_the_weight_image_decodes_to_the_weights(site):
    """Each slab's image, read through the descriptors' addressing, is the
    slab's rows of W with K and the slab zero-padded; the bias image is the
    bf16 bias in f32, zero-padded; the slabs tile N."""
    k, n, _, _ = SITES[site]
    _, w, b, _ = _inputs(site, 1, seed=k * n)
    kw = tl.token_linear_weights(w, b)
    ns, nw = tl.SLABS[k]
    kp = -(-k // 16) * 16
    assert kw.image.shape == (-(-n // ns), -(-kp // 64), nw, 8, 8) and kw.bias.shape == (-(-n // ns), nw)
    for s in range(kw.image.shape[0]):
        want = torch.zeros(nw, kp, dtype=torch.bfloat16)
        cols = min(ns, n - s * ns)
        want[:cols, :k] = w[s * ns:s * ns + cols]
        assert torch.equal(decode_image(kw, s), want)
        assert torch.equal(kw.bias[s], F.pad(b[s * ns:s * ns + cols].float(), (0, nw - cols)))


ERFCC = (0.17087277, -0.82215223, 1.48851587, -1.13520398, 0.27886807, -0.18628806, 0.09678418, 0.37409196,
         1.00002368, -1.26551223)  # gelu_erf's polynomial, highest power first


def gelu_erf(v):
    """The kernel's GELU in f32: v Phi(v), erfc(|v| / sqrt 2) = t exp(-z^2 +
    P(t)), t = 1 / (1 + z / 2), then Phi = e / 2 below 0 and 1 - e / 2 above."""
    z = v.abs() * 0.70710678
    t = 1 / (1 + 0.5 * z)
    p = torch.full_like(t, ERFCC[0])
    for c in ERFCC[1:]:
        p = t * p + c
    e = t * torch.exp(p - z * z)
    return v * torch.where(v >= 0, 1 - 0.5 * e, 0.5 * e)


def test_the_kernels_gelu_is_nearer_exact_than_the_erf_form():
    """On a grid of f32 inputs, rounded to bf16: the kernel's GELU differs from
    GELU in f64 in fewer values than ``0.5 v (1 + erf(v / sqrt 2))`` in f32
    (which cancels below about -3), and by at most 2e-6 of |v| anywhere."""
    v = torch.linspace(-8, 8, 200_001)
    exact = v.double() * 0.5 * torch.erfc(-v.double() / 2**0.5)
    mine, erf_form = gelu_erf(v), F.gelu(v)
    assert (mine.double() - exact).abs().le(2e-6 * v.double().abs() + 1e-30).all()
    assert int((mine.bfloat16() != exact.bfloat16()).sum()) < int((erf_form.bfloat16() != exact.bfloat16()).sum())


def emulate(x, kw, gelu, residual):
    """``token_linear_kernel``'s arithmetic in f32: per slab, the tokens
    zero-padded to whole k-steps times the decoded image, the bias, GELU
    (``gelu_erf``) or the residual added to the f32 sum, one rounding, and
    only the slab's own columns stored."""
    k, n = kw.k, kw.n
    ns = tl.SLABS[k][0]
    xp = F.pad(x.reshape(-1, k).float(), (0, -(-k // 16) * 16 - k))
    y = torch.full((xp.shape[0], n), float("nan"), dtype=torch.bfloat16)
    for s in range(kw.image.shape[0]):
        cols = min(ns, n - s * ns)
        v = (xp @ decode_image(kw, s).float().T + kw.bias[s])[:, :cols]
        if gelu:
            v = gelu_erf(v)
        if residual is not None:
            v = v + residual.reshape(-1, n)[:, s * ns:s * ns + cols].float()
        y[:, s * ns:s * ns + cols] = v.bfloat16()
    return y.reshape(x.shape[:-1] + (n,))


# Outputs nearer zero than this carry more f32 rounding (two f32 sums of K
# products of unit-scale operands, in different orders, differ by ~1e-6)
# than bf16's spacing there: the ulp is taken at this magnitude at least.
ULP_FLOOR = 2.0**-10


def bf16_ulp(t):
    """The spacing of bf16 values at each of ``t``'s magnitudes (at least at ``ULP_FLOOR``)."""
    _, e = torch.frexp(t.float().abs().clamp(min=ULP_FLOOR))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def off_by_more_than_one_ulp(got, ref):
    return int(((got.float() - ref.float()).abs() > bf16_ulp(ref)).sum())


@pytest.mark.parametrize("rows", [1, 70])
@pytest.mark.parametrize("site", list(SITES))
def test_the_kernels_arithmetic_mirrored_is_the_f32_composition(site, rows):
    """The mirror of the kernel's arithmetic is the f32 composition rounded
    once, to one bf16 ulp (``ULP_FLOOR``), every column stored once."""
    k, n, gelu, _ = SITES[site]
    x, w, b, r = _inputs(site, rows, seed=rows + n)
    got = emulate(x, tl.token_linear_weights(w, b), gelu, r)
    assert not got.isnan().any()
    assert off_by_more_than_one_ulp(got, _f32_once(x, w, b, gelu, r)) == 0


def kernel_walk(rows, site, sms):
    """``launch``'s grid and ``token_linear_kernel``'s walk: block i takes slab
    i % slabs; its warpgroup g of w the tiles w (i // slabs) + g, stepping by
    w times the grid's groups. Returns {(tile, slab): [(block, warpgroup), ...]}."""
    k, n, _, _ = SITES[site]
    ns, wgs = tl.SLABS[k][0], warpgroups(site)
    slabs, tiles = -(-n // ns), -(-rows // KERNEL_ROWS)
    groups = max(1, min(sms // slabs, -(-tiles // wgs)))
    taken = {}
    for block in range(groups * slabs):
        for g in range(wgs):
            for t in range(wgs * (block // slabs) + g, tiles, wgs * groups):
                taken.setdefault((t, block % slabs), []).append((block, g))
    return taken, tiles, slabs


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 4095, 4096 + 127, 16384, CELL_TOKENS])
@pytest.mark.parametrize("site", list(SITES))
def test_every_tile_and_slab_is_taken_once(site, rows):
    """At the cell's rows, serving's 4,096 and 16,384 and ragged counts, on
    132 SMs and on 7: every (tile, slab) is taken by exactly one warpgroup,
    and a tile's slabs by the same warpgroup of one group's blocks (so x's
    reads after the first hit L2)."""
    for sms in (132, 7):
        taken, tiles, slabs = kernel_walk(rows, site, sms)
        assert sorted(taken) == [(t, s) for t in range(tiles) for s in range(slabs)]
        assert all(len(v) == 1 for v in taken.values())
        for t in range(tiles):
            assert len({(b // slabs, g) for s in range(slabs) for b, g in taken[(t, s)]}) == 1


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [CELL_TOKENS, 1, 4095, 4096 + 127])
@pytest.mark.parametrize("site", list(SITES))
def test_cuda_token_linear_matches_the_f32_composition(cuda, site, rows):
    """At the cell's 704,512 tokens and at ragged row counts: one launch
    counted, and within one bf16 ulp of the f32 composition rounded once (the
    tensor cores sum the K products in another order than the f32 GEMM, so a
    value next to a rounding boundary may round the other way; the ulp taken
    at 2^-10 at least: ``ULP_FLOOR``)."""
    k, n, gelu, _ = SITES[site]
    x, w, b, r = _inputs(site, rows, seed=rows % 1000 + n, device=cuda)
    before = tl.LAUNCHES.count
    with torch.no_grad():
        got = tl.token_linear(x, w, b, gelu, r)
    torch.cuda.synchronize()
    assert tl.LAUNCHES.count == before + 1
    assert got.shape == (rows, n) and got.dtype == torch.bfloat16
    ref = _f32_once(x, w, b, gelu, r)
    assert off_by_more_than_one_ulp(got, ref) == 0, (got.float() - ref.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(SITES))
def test_cuda_token_linear_is_no_further_from_exact_than_the_chain(cuda, site):
    """At the cell's tokens, against the composition in f64 rounded to bf16:
    the kernel's answer (one rounding) differs in no more values than torch's
    bf16 chain's (cuBLAS's GEMM with its bias, then GELU or the add, each
    rounded), beyond three times the count's own sampling noise: at qkv the
    chain rounds once too, and the two differ from the exact answer only where
    their f32 sums, taken in different orders, straddle a rounding boundary."""
    k, n, gelu, _ = SITES[site]
    x, w, b, r = _inputs(site, CELL_TOKENS, seed=n, device=cuda)
    with torch.no_grad():
        got = tl.token_linear(x, w, b, gelu, r)
        chain = tl.token_linear_reference(x, w, b, gelu, r)
        exact = tl.token_linear_reference(x.double(), w.double(), b.double(), gelu,
                                          None if r is None else r.double()).bfloat16()
    kernel_off, chain_off = int((got != exact).sum()), int((chain != exact).sum())
    assert kernel_off <= chain_off + 3 * chain_off**0.5, (kernel_off, chain_off)


@pytest.mark.cuda
def test_cuda_token_linear_replays_in_a_graph(cuda):
    """Captured in a CUDA graph and replayed on new tokens and residual, the
    kernel gives what an eager call gives, bit for bit: it launches on the
    current stream and allocates nothing."""
    x, w, b, r = _inputs("fc2", 5000, seed=11, device=cuda)
    x2, _, _, r2 = _inputs("fc2", 5000, seed=12, device=cuda)
    kw = tl.token_linear_weights(w, b)
    with torch.no_grad():
        tl.token_linear_launch(x, kw, residual=r)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tl.token_linear_launch(x, kw, residual=r)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tl.token_linear_launch(x, kw, residual=r)
        x.copy_(x2)
        r.copy_(r2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tl.token_linear_launch(x2, kw, residual=r2))


@pytest.mark.cuda
@pytest.mark.parametrize("side", [64, 128])
@pytest.mark.parametrize("site", list(SITES))
def test_cuda_token_linear_no_slower_than_the_chain_at_serving_sizes(cuda, site, side):
    """At serving sizes (B1 x 64^2 and 128^2 tokens), 50 launches in a CUDA
    graph as a served forward runs them: the kernel's device time no more
    than the chain's it replaces (``F.linear``, then ``F.gelu`` or the add;
    CUDA events, median of 5 replays)."""
    from esr_tpu_torch.ops.cuda.conv_bench import graph_ms

    k, n, gelu, _ = SITES[site]
    x, w, b, r = _inputs(site, side * side, seed=side, device=cuda)
    kw = tl.token_linear_weights(w, b)
    with torch.no_grad():
        ms = graph_ms(lambda: tl.token_linear_launch(x, kw, gelu, r), reps=50)
        chain_ms = graph_ms(lambda: tl.token_linear_reference(x, w, b, gelu, r), reps=50)
    assert ms <= chain_ms, (ms, chain_ms)
