"""The bf16 fused RDB kernel's layouts and work (csrc/rdb5c.cuh), held on the CPU.

The kernel, ``rdb5c_tc_kernel<NF, GC, TILE>``, runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py). What surrounds it is index
arithmetic, mirrored here in Python from the CUDA source and checked without
a GPU, for each of its instances (``rdb_conv.INSTANCES``: 32 / 16 / 16, 64 /
32 / 16, 128 / 64 / 8):

- the weight image that ``rdb5c_weight_image`` builds decodes back to every
  HWIO ``w1..w5`` slice through the kernel's wgmma descriptor addressing
  (128-byte swizzle included), with zeros in the padding;
- the producer's stage schedule (59 stages of 8 KB at 64 / 32, in order) is
  the one the consumers' k-steps read, each (conv, source, tap) once, each
  k-block inside one ring slot, each stage released once after its last
  read;
- the M-tiles of the consumer warpgroups (or, for a conv of one M-tile, the
  warpgroups' shares of its cout) cover every (pixel, channel) of each
  shrinking window exactly once, in the A rows and in the accumulators;
- a bf16 width takes the narrowest instance that holds it, zero-padded to
  it, and a width past the widest raises;
- an f32 emulation of the kernel's persistent tile walk (TMA window with zero
  fill and the TMA's swizzle, weight ring, one GEMM per k-step with A by the
  swizzled ldmatrix rows, image-edge re-zeroing, residual) equals
  ``rdb5c_reference``, and, at nf 16 / gc 8 padded to 32 / 16, the Pallas
  kernel in interpret mode.

f32 throughout, inputs from numpy seeds; tolerance 1e-5 against
``rdb5c_reference`` (five chained convs of K <= 3456 terms summed in another
order), 2e-4 against the Pallas kernel (tests/test_torch_kernels.py's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.ops.pallas.rdb_conv import fused_rdb5c as jax_fused_rdb5c
from esr_tpu_torch.ops.cuda import rdb_conv

torch.set_num_threads(1)

ATOL = 1e-5
PALLAS_ATOL = 2e-4
MAIN = (64, 32, 16)
SLOTS = 3  # kRdbSlots
GROUPS = 2  # kRdbGroups: consumer warpgroups
SMEM_LIMIT = 232448  # bytes of shared memory a block can use


# -- the kernel's constants (rdb5c.cuh, struct Rdb), mirrored -------------------------


def _align(v, a):
    return -(-v // a) * a


class Inst:
    """One instance <NF, GC, TILE> of rdb5c_tc_kernel."""

    def __init__(self, nf, gc, tile):
        self.nf, self.gc, self.tile, self.win = nf, gc, tile, tile + 10
        self.stage = max(8192, 128 * nf)
        self.plane = _align(self.win**2 * 128, 1024) if nf > 64 else self.win**2 * nf * 2
        self.w_bytes = self.wbase(6)
        self.n_stages = self.w_bytes // self.stage
        self.smem_bytes = 1024 + self.feat_off(5) + 8 * 8

    def __repr__(self):
        return f"{self.nf}-{self.gc}-{self.tile}"

    def edge(self, j):
        return self.win - 2 * j

    def chunks(self, j):
        return self.nf // 8 if j == 0 else self.gc // 8

    def feat_off(self, j):
        off = SLOTS * self.stage
        for i in range(j):
            off += -(-self.nf // 64) * self.plane if i == 0 else self.edge(i) ** 2 * self.chunks(i) * 16
        return off

    def cin(self, k):
        return self.nf + self.gc * (k - 1)

    def cout(self, k):
        return self.gc if k < 5 else self.nf

    def kblock_bytes(self, k):
        return self.cout(k) * 128

    def kblocks(self, k):
        return -(-9 * self.cin(k) // 64)

    def wbase(self, k):
        off = 0
        for i in range(1, k):
            off = _align(off + self.kblocks(i) * self.kblock_bytes(i), self.kblock_bytes(i + 1) if i < 5 else self.stage)
        return off

    def out_edge(self, k):
        return self.edge(k) if k < 5 else self.tile

    def mtiles(self, k):
        return -(-self.out_edge(k) ** 2 // 64)

    def chunk_byte(self, j, p, q):
        """The byte offset where 16-byte chunk q of pixel p of feature j
        lies (the kernel's feat_off(j) + 16 chunk(j, p, q): swz(p, q,
        chunks) per 64-channel plane)."""
        if j == 0 and self.nf > 64:
            return self.feat_off(0) + (q // 8) * self.plane + _swz(p, q % 8, 8) * 16
        return self.feat_off(j) + _swz(p, q, self.chunks(j)) * 16

    def k_steps(self, k):
        """Conv k's k-steps in the consumers' order: (tap, source j, first
        channel of j, byte offset of the k-block in the image, K offset in it)."""
        ks, xs, js = self.cin(k) // 16, self.nf // 16, self.gc // 16
        for tap in range(9):
            for cs in range(ks):
                s = tap * ks + cs
                j, c0 = (0, 16 * cs) if cs < xs else (1 + (cs - xs) // js, 16 * ((cs - xs) % js))
                yield tap, j, c0, self.wbase(k) + (s >> 2) * self.kblock_bytes(k), (s & 3) * 32

    def group_work(self, k, g):
        """Warpgroup g's share of conv k: [(M-tile, first channel, channels)].
        M-tiles g, g + GROUPS, .. (the first M-tiles % GROUPS groups take one
        more) at every channel; a conv of fewer M-tiles than groups: its one
        M-tile at the group's slice of cout."""
        if self.mtiles(k) < GROUPS:
            n = self.cout(k) // GROUPS
            return [(0, g * n, n)]
        lo, rem = divmod(self.mtiles(k), GROUPS)
        return [(GROUPS * i + g, 0, self.cout(k)) for i in range(lo + (g < rem))]


INSTS = [Inst(*i) for i in rdb_conv.INSTANCES]


def _swz(p, q, ch):
    """common.cuh's swz(p, q, ch) / 8: the chunk index of chunk q of pixel p."""
    s = (p & 7) if ch >= 8 else ((p * ch) >> 3) & (ch - 1)
    return p * ch + (q ^ s)


def sw128(addr):
    """128B swizzle of a byte address in a 1024-byte aligned buffer (TMA's
    and wgmma's)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def sw64(addr):
    """TMA's 64B swizzle: address bits [4:5] ^= bits [7:8]."""
    return addr ^ (((addr >> 7) & 3) << 4)


def _width_params(nf, gc, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for k in range(1, 6):
        ci, co = nf + (k - 1) * gc, nf if k == 5 else gc
        p[f"w{k}"] = torch.from_numpy((rng.standard_normal((3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5).astype(np.float32))
        p[f"b{k}"] = torch.from_numpy((0.1 * rng.standard_normal(co)).astype(np.float32))
    return p


def _padded(p, nf, gc, nf_p, gc_p):
    """The weights and biases of an (nf, gc) RDB placed in zeros of the
    (nf_p, gc_p) widths: each source feature's cin slice at its padded
    offset, the output channels first."""
    out = {}
    for k in range(1, 6):
        cout, cout_p = (nf, nf_p) if k == 5 else (gc, gc_p)
        w = torch.zeros(3, 3, nf_p + (k - 1) * gc_p, cout_p, dtype=p[f"w{k}"].dtype)
        src = [(0, 0, nf)] + [(nf + (j - 1) * gc, nf_p + (j - 1) * gc_p, gc) for j in range(1, k)]
        for a, b, c in src:
            w[:, :, b:b + c, :cout] = p[f"w{k}"][:, :, a:a + c]
        out[f"w{k}"] = w
        out[f"b{k}"] = torch.cat([p[f"b{k}"], p[f"b{k}"].new_zeros(cout_p - cout)])
    return out


# -- layouts -------------------------------------------------------------------


def test_weight_image_decodes_to_hwio():
    _check_weight_image(Inst(*MAIN))


@pytest.mark.parametrize("inst", INSTS[::2], ids=repr)
def test_weight_image_decodes_to_hwio_at_other_instances(inst):
    _check_weight_image(inst)


def _check_weight_image(inst):
    """Each k-step's B operand, read the way the kernel's descriptor reads it
    (row n at 128 n bytes of its k-block, K step at 32 bytes, swizzled by
    address), is w_k[ty, tx, the step's 16 channels, :] transposed, exactly;
    every other element of the image is zero (the k-blocks' padding, the
    gaps that align each conv's k-blocks and the last stage); the bf16
    layout is the image of the bf16-rounded weights."""
    p = _width_params(inst.nf, inst.gc, 3)
    img = rdb_conv.rdb5c_weight_image(p)
    assert img.numel() * 2 == inst.w_bytes and inst.w_bytes % inst.stage == 0
    if (inst.nf, inst.gc, inst.tile) == MAIN:
        assert inst.w_bytes == 483328 and inst.n_stages == 59
    kk = torch.arange(16)[None, :]
    read = torch.zeros(img.numel(), dtype=torch.bool)
    for k in range(1, 6):
        n = torch.arange(inst.cout(k))[:, None]
        concat_off = [0] + [inst.nf + inst.gc * (i - 1) for i in range(1, k)]
        for tap, j, c0, kb, koff in inst.k_steps(k):
            idx = sw128(kb + n * 128 + koff + kk * 2) // 2  # [N, 16]
            want = p[f"w{k}"][tap // 3, tap % 3, concat_off[j] + c0: concat_off[j] + c0 + 16, :].T
            assert torch.equal(img[idx], want), (k, tap, j, c0)
            assert not read[idx].any()
            read[idx] = True
    assert not img[~read].any()  # only padding is never read, and it is zero
    assert read.sum().item() == sum(9 * inst.cin(k) * inst.cout(k) for k in range(1, 6))
    bf = rdb_conv.rdb5c_kernel_weights(p, torch.bfloat16, torch.device("cpu"))
    assert bf.instance == (inst.nf, inst.gc, inst.tile) and bf.image.dtype == torch.bfloat16
    assert torch.equal(bf.image.float(), rdb_conv.rdb5c_weight_image(
        {k: v.bfloat16().float() for k, v in p.items()}))


def test_stage_schedule_producer_equals_consumers():
    _check_stage_schedule(Inst(*MAIN))


@pytest.mark.parametrize("inst", INSTS[::2], ids=repr)
def test_stage_schedule_producer_equals_consumers_at_other_instances(inst):
    _check_stage_schedule(inst)


def _check_stage_schedule(inst):
    """The producer copies the instance's stages in order, stage t to slot t %
    3. The consumers' k-steps touch the same stages in the same order (each
    first touch waits on the slot's full barrier), every k-block lies inside
    its stage, every (conv, source, tap) comes once with all its channels,
    and each stage is released once, after its last read (the kernel's
    ``fresh`` logic and the release at the tile's end). The windows and the
    ring fit a block's shared memory, the TMA planes 1024-byte aligned."""
    producer = [(t, t * inst.stage, t % SLOTS) for t in range(inst.n_stages)]
    touched, seen, cur, released = [], {}, -1, []
    for k in range(1, 6):
        for step, (tap, j, c0, kb, koff) in enumerate(inst.k_steps(k)):
            st = kb // inst.stage
            assert kb % inst.stage + inst.kblock_bytes(k) <= inst.stage  # the k-block fits its slot
            assert kb % inst.kblock_bytes(k) == 0 and koff + 32 <= 128
            if st != cur:
                touched.append((st, st * inst.stage, st % SLOTS))
                if cur >= 0:
                    released.append(cur)
                cur = st
            seen.setdefault((k, j, tap), []).append(c0)
            assert step < 9 * inst.cin(k) // 16
    released.append(cur)  # at the tile's end
    assert touched == producer
    assert released == list(range(inst.n_stages))
    assert inst.n_stages > SLOTS  # the producer loads a later tile's window at its stage 3
    for k in range(1, 6):
        for j in range(k):
            for tap in range(9):
                assert sorted(seen.pop((k, j, tap))) == list(range(0, inst.chunks(j) * 8, 16))
    assert not seen
    assert max(inst.kblock_bytes(k) for k in range(1, 6)) <= inst.stage
    assert inst.feat_off(0) % 1024 == 0  # the TMA window and the ring slots are 1024-aligned
    assert inst.nf <= 64 or inst.plane % 1024 == 0  # each 64-channel plane too
    if (inst.nf, inst.gc, inst.tile) == MAIN:
        assert inst.feat_off(5) - inst.feat_off(0) == 200704
    assert inst.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("inst,k", [(i, k) for i in INSTS for k in range(1, 6)],
                         ids=[str(k) if (i.nf, i.gc, i.tile) == MAIN else f"{i!r}-{k}" for i in INSTS for k in range(1, 6)])
def test_mtiles_cover_each_pixel_once(inst, k):
    """The consumer warpgroups' work: the A rows (warp w, lane l: row 16 w +
    l % 16) and the accumulators (rows 16 w + l / 4 + 8 hf, channels n0 + 8
    jn + 2 (l % 4) + e) cover every (pixel, channel) of conv k's output
    region once. Each warpgroup has work; M-tiles differ by at most one."""
    npx, n = inst.out_edge(k) ** 2, inst.cout(k)
    cells = []
    for g in range(GROUPS):
        rows = []
        work = inst.group_work(k, g)
        assert work
        for mi, n0, ncols in work:
            assert ncols % 8 == 0 and ncols in (16, 32, 64)  # the Wgmma<N> specializations
            for w4 in range(4):
                rows += [mi * 64 + 16 * w4 + ln for ln in range(16)]
                for lane in range(32):
                    for hf in range(2):
                        p = mi * 64 + 16 * w4 + lane // 4 + 8 * hf
                        cells += [(p, n0 + 8 * jn + 2 * (lane % 4) + e) for jn in range(ncols // 8) for e in range(2)]
        assert len(set(rows)) == len(rows)
    live = sorted(c for c in cells if c[0] < npx)
    assert live == [(p, c) for p in range(npx) for c in range(n)]
    counts = [len(inst.group_work(k, g)) for g in range(GROUPS)]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("nf,gc,inst", [
    (8, 4, (32, 16, 16)), (16, 8, (32, 16, 16)), (12, 6, (32, 16, 16)), (32, 16, (32, 16, 16)),
    (48, 24, (64, 32, 16)), (128, 64, (128, 64, 8)), (100, 40, (128, 64, 8))], ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_bf16_tiles_are_hints_and_other_widths_take_an_instance(nf, gc, inst):
    """bf16 tiles are a schedule hint (no tile raises; the kernel runs its
    instance's tile whatever is asked), nf 64 / gc 32 takes the main
    instance, and every other bf16 width the narrowest instance that holds
    it: the image of its weights placed in zeros of the instance's widths
    (each source feature's cin slice, the output channels), the biases
    zero-padded. The padded block, run on x padded with zero channels, is the
    block. f32 at the same widths takes the f32 conv layouts, unpadded."""
    p = _width_params(*MAIN[:2], 4)
    x = torch.zeros(1, 8, 8, MAIN[0], dtype=torch.bfloat16)
    for strip, wtile in ((8, 8), (12, 8), (16, 12), (16, 16)):
        assert rdb_conv.fused_rdb5c_tiled(x, p, strip=strip, wtile=wtile).shape == x.shape
    assert rdb_conv.rdb5c_kernel_weights(p, torch.bfloat16, torch.device("cpu")).instance == MAIN
    q = _width_params(nf, gc, seed=nf + gc)
    kw = rdb_conv.rdb5c_kernel_weights(q, torch.bfloat16, torch.device("cpu"))
    nf_p, gc_p, _ = inst
    assert (kw.nf, kw.gc, kw.instance) == (nf, gc, inst) and rdb_conv.rdb5c_instance(nf, gc) == inst
    padded = _padded(q, nf, gc, nf_p, gc_p)
    want = rdb_conv.rdb5c_weight_image({k: v.bfloat16() if k[0] == "w" else v for k, v in padded.items()})
    assert kw.image.dtype == torch.bfloat16 and torch.equal(kw.image, want)
    assert kw.image.numel() * 2 == Inst(*inst).w_bytes
    for k in range(1, 6):
        b = kw.bs[k - 1]
        assert b.dtype == torch.float32 and torch.equal(b, padded[f"b{k}"])
    xs = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 9, 11, nf)).astype(np.float32))
    got = rdb_conv.rdb5c_reference(torch.nn.functional.pad(xs, (0, nf_p - nf)), padded)
    assert not got[..., nf:].any()
    torch.testing.assert_close(got[..., :nf], rdb_conv.rdb5c_reference(xs, q), atol=ATOL, rtol=0)
    # f32 takes the five convs' f32 conv layouts, unpadded widths
    # (tests/test_torch_f32_conv.py runs them)
    kw32 = rdb_conv.rdb5c_kernel_weights(q, torch.float32, torch.device("cpu"))
    assert isinstance(kw32, rdb_conv.Rdb5cF32Weights) and (kw32.nf, kw32.gc) == (nf, gc)
    for k, conv in enumerate(kw32.convs, start=1):
        assert conv.route == "f32" and conv.wt.dtype == torch.float32
        assert (conv.cin, conv.cout) == (nf + (k - 1) * gc, nf if k == 5 else gc)


@pytest.mark.parametrize("nf,gc", [(136, 32), (64, 72), (256, 128)])
def test_bf16_width_past_the_widest_instance_raises(nf, gc):
    """A bf16 RDB wider than nf 128 / gc 64 has no instance: building its
    layout raises ValueError naming the limit, without a card (the layout
    is built before any launch) and without counting a layout; the CPU runs
    the block at that width, as f32 builds its layout."""
    p = _width_params(nf, gc, seed=1)
    before = rdb_conv.LAYOUTS.count
    with pytest.raises(ValueError, match="nf up to 128 and gc up to 64"):
        rdb_conv.rdb5c_kernel_weights(p, torch.bfloat16, torch.device("cpu"))
    assert rdb_conv.LAYOUTS.count == before
    x = torch.zeros(1, 3, 4, nf, dtype=torch.bfloat16)
    assert rdb_conv.fused_rdb5c(x, p).shape == x.shape
    assert isinstance(rdb_conv.rdb5c_kernel_weights(p, torch.float32, torch.device("cpu")), rdb_conv.Rdb5cF32Weights)


# -- the kernel's work, emulated ---------------------------------------------------


def _tma_window(inst, smem, x, n, gy0, gx0):
    """The window's boxes at (gy0, gx0), zero outside the image, each
    64-channel plane 128B-swizzled (nf 32: one plane, 64B-swizzled) at its
    (1024-aligned) offset."""
    _, h, w, c_all = x.shape
    win = inst.win
    box = torch.zeros(win, win, c_all)
    ys, xs = slice(max(gy0, 0), min(gy0 + win, h)), slice(max(gx0, 0), min(gx0 + win, w))
    box[ys.start - gy0:ys.stop - gy0, xs.start - gx0:xs.stop - gx0] = x[n, ys, xs]
    box = box.reshape(-1, c_all)
    p = torch.arange(win * win)[:, None]
    for c0 in range(0, c_all, 64):
        bc = min(64, c_all)
        c = torch.arange(bc)[None, :]
        base = inst.feat_off(0) + (c0 // 64) * inst.plane
        sw = sw128 if bc == 64 else sw64
        smem[sw(base + p * bc * 2 + 2 * c) // 2] = box[:, c0:c0 + bc]


def _conv(inst, smem, ring, img, k):
    """Conv k's implicit GEMM over every warpgroup's work: [(rows, cols,
    acc [rows, cols])], one entry per column slice (the rows of all M-tiles
    at that slice of cout)."""
    o = inst.out_edge(k)
    slices = {}
    for g in range(GROUPS):
        for mi, n0, ncols in inst.group_work(k, g):
            slices.setdefault((n0, ncols), []).append(mi)
    out = []
    kk = torch.arange(16)[None, :]
    for (n0, ncols), mts in slices.items():
        rows = torch.tensor([mi * 64 + r for mi in mts for r in range(64)])
        pc = torch.where(rows < o * o, rows, 0)  # rows past the region read pixel 0
        r, c = (pc // o)[:, None], (pc % o)[:, None]
        n = torch.arange(ncols)[:, None]
        acc = torch.zeros(len(rows), ncols)
        for tap, j, c0, kb, koff in inst.k_steps(k):
            s = k - 1 - j
            p = (r + s + tap // 3) * inst.edge(j) + c + s + tap % 3
            a_op = smem[(inst.chunk_byte(j, p, c0 // 8 + kk // 8) + (kk % 8) * 2) // 2]
            st = kb // inst.stage
            slot = st % SLOTS
            if ring.get(slot) != st:  # the producer's copy of stage st into its slot
                e = inst.stage // 2
                smem[slot * e:(slot + 1) * e] = img[st * e:(st + 1) * e]
                ring[slot] = st
            b_op = smem[sw128(slot * inst.stage + kb % inst.stage + (n0 + n) * 128 + koff + kk * 2) // 2]
            acc += a_op @ b_op.T
        out.append((rows, torch.arange(n0, n0 + ncols), acc))
    return out


def _epilogue(inst, smem, out, rows, cols, acc, bias, k, n, y0, x0, rezero=True):
    _, h, w, _ = out.shape
    o = inst.out_edge(k)
    live = rows < o * o
    p, v = rows[live][:, None], acc[live] + bias[cols]
    col = cols[None, :]
    r, c = p // o, p % o
    if k < 5:
        gy, gx = y0 - 5 + k + r, x0 - 5 + k + c
        v = torch.where(v >= 0, v, 0.2 * v)
        if rezero:  # SAME padding of the next conv: zero outside the image
            v = torch.where((gy >= 0) & (gy < h) & (gx >= 0) & (gx < w), v, 0.0)
        smem[(inst.chunk_byte(k, p, col // 8) + (col % 8) * 2) // 2] = v
    else:
        gy, gx = y0 + r, x0 + c
        xw = (r + 5) * inst.win + c + 5
        xv = smem[(inst.chunk_byte(0, xw, col // 8) + (col % 8) * 2) // 2]
        keep = ((gy < h) & (gx < w))[:, 0]
        out[n, gy[keep], gx[keep], col] = (xv + 0.2 * v)[keep]


def _emulate(inst, x, p, grid, rezero=True):
    """rdb5c_tc_kernel<nf, gc, tile>'s work, step by step, in f32: blocks b
    < grid walk the tiles b, b + grid, ..; shared memory starts as NaN, so a
    read of a pixel no thread wrote shows."""
    n_img, h, w, _ = x.shape
    img = rdb_conv.rdb5c_weight_image(p)
    tiles_x, tiles_y = -(-w // inst.tile), -(-h // inst.tile)
    n_tiles = n_img * tiles_x * tiles_y
    out = torch.full_like(x, float("nan"))
    for blk in range(grid):
        smem = torch.full((inst.smem_bytes // 2,), float("nan"))
        ring = {}
        for t in range(blk, n_tiles, grid):
            n, r = divmod(t, tiles_x * tiles_y)
            y0, x0 = (r // tiles_x) * inst.tile, (r % tiles_x) * inst.tile
            _tma_window(inst, smem, x, n, y0 - 5, x0 - 5)
            for k in range(1, 6):
                for rows, cols, acc in _conv(inst, smem, ring, img, k):
                    _epilogue(inst, smem, out, rows, cols, acc, p[f"b{k}"], k, n, y0, x0, rezero)
    return out


# (instance, shape, grid, id): ragged grids with a batch, batch 1, an image
# smaller than a tile, H and W that are not tile multiples
WALKS = [(MAIN, (2, 37, 53), 5, "ragged"), (MAIN, (1, 16, 40), 2, "b1"), (MAIN, (1, 5, 7), 1, "smaller-than-a-tile"),
         (MAIN, (1, 33, 18), 4, "h-w-not-tile-multiples"),
         ((32, 16, 16), (2, 21, 35), 3, "32-16-16-ragged"), ((32, 16, 16), (1, 16, 40), 2, "32-16-16-b1"),
         ((32, 16, 16), (1, 5, 7), 1, "32-16-16-smaller-than-a-tile"),
         ((128, 64, 8), (2, 11, 13), 3, "128-64-8-ragged"), ((128, 64, 8), (1, 8, 20), 2, "128-64-8-b1"),
         ((128, 64, 8), (1, 5, 7), 1, "128-64-8-smaller-than-a-tile")]


@pytest.mark.parametrize("inst,shape,grid", [w[:3] for w in WALKS], ids=[w[3] for w in WALKS])
def test_emulated_tile_walk_matches_reference(inst, shape, grid):
    nf, gc, _ = inst
    p = _width_params(nf, gc, sum(shape))
    x = torch.from_numpy(np.random.default_rng(len(shape) + grid).standard_normal(shape + (nf,)).astype(np.float32))
    got = _emulate(Inst(*inst), x, p, grid)
    assert not torch.isnan(got).any()  # every output pixel written, from written pixels only
    torch.testing.assert_close(got, rdb_conv.rdb5c_reference(x, p), atol=ATOL, rtol=0)


def test_emulation_sees_the_image_edge_rezeroing():
    _check_rezeroing(Inst(*MAIN))


@pytest.mark.parametrize("inst", INSTS[::2], ids=repr)
def test_emulation_sees_the_image_edge_rezeroing_at_other_instances(inst):
    _check_rezeroing(inst)


def _check_rezeroing(inst):
    """Without the re-zeroing of x_1..x_4 outside the image the same walk is
    far off at the image edge: the comparison above can see that fault."""
    shape = (1, inst.tile, 2 * inst.tile + 4)
    p = _width_params(inst.nf, inst.gc, sum(shape))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape + (inst.nf,)).astype(np.float32))
    off = (_emulate(inst, x, p, 2, rezero=False) - rdb_conv.rdb5c_reference(x, p)).abs().max().item()
    assert off > 100 * ATOL


def test_emulated_padded_walk_matches_pallas_interpret():
    """nf 16 / gc 8 (the JAX package's kernel test width) as the card runs
    it: the weights placed in zeros of the 32 / 16 instance, x padded with
    zero channels, the instance's emulated walk, the output cut back; against
    the Pallas kernel in interpret mode on the same numpy-seeded inputs."""
    nf, gc = 16, 8
    inst = Inst(*rdb_conv.rdb5c_instance(nf, gc))
    assert (inst.nf, inst.gc, inst.tile) == (32, 16, 16)
    p = _width_params(nf, gc, 11)
    x = np.random.default_rng(12).standard_normal((2, 13, 18, nf)).astype(np.float32)
    ref = np.asarray(jax_fused_rdb5c(jnp.asarray(x), {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                                     interpret=True, strip=6))
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, inst.nf - nf))
    got = _emulate(inst, xp, _padded(p, nf, gc, inst.nf, inst.gc), 2)
    assert not got[..., nf:].any()
    np.testing.assert_allclose(got[..., :nf].numpy(), ref, atol=PALLAS_ATOL)
