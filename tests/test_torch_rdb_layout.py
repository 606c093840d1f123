"""The bf16 fused RDB kernel's layouts and work (csrc/rdb5c.cuh), held on the CPU.

The kernel, ``rdb5c_tc_kernel``, runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py). What surrounds it is index arithmetic, mirrored here in
Python from the CUDA source and checked without a GPU:

- the weight image that ``rdb5c_weight_image`` builds decodes back to every
  HWIO ``w1..w5`` slice through the kernel's wgmma descriptor addressing
  (128-byte swizzle included), with zeros in the padding;
- the producer's stage schedule (59 stages of 8 KB, in order) is the one the
  consumers' k-steps read, each (conv, source, tap) once, each k-block inside
  one ring slot, each stage released once after its last read;
- the M-tiles of the consumer warpgroups cover every pixel of each
  shrinking window exactly once, in the A rows and in the accumulators;
- an f32 emulation of the kernel's persistent tile walk (TMA window with zero
  fill, weight ring, one GEMM per k-step with A by the swizzled ldmatrix
  rows, image-edge re-zeroing, residual) equals ``rdb5c_reference``.

f32 throughout, inputs from numpy seeds; tolerance 1e-5 (five chained convs
of K <= 1728 terms summed in another order).
"""

import numpy as np
import pytest
import torch

from esr_tpu_torch.ops.cuda import rdb_conv

torch.set_num_threads(1)

ATOL = 1e-5
NF, GC = 64, 32
TILE, WIN = 16, 26  # kRdbTile, kRdbWin
STAGE, SLOTS = 8192, 3  # kRdbStage, kRdbSlots
GROUPS = 2  # kRdbGroups: consumer warpgroups
SMEM_LIMIT = 232448  # bytes of shared memory a block can use


# -- the kernel's constants (rdb5c.cuh), mirrored ---------------------------------


def edge(j):
    return WIN - 2 * j


def chunks(j):
    return 8 if j == 0 else 4


def feat_off(j):
    return SLOTS * STAGE + sum(edge(i) ** 2 * chunks(i) * 16 for i in range(j))


def cin(k):
    return NF + GC * (k - 1)


def cout(k):
    return GC if k < 5 else NF


def kblock_bytes(k):
    return cout(k) * 128


def kblocks(k):
    return -(-9 * cin(k) // 64)


def wbase(k):
    return sum(kblocks(i) * kblock_bytes(i) for i in range(1, k))


def out_edge(k):
    return edge(k) if k < 5 else TILE


def mtiles(k):
    return -(-out_edge(k) ** 2 // 64)


W_BYTES = wbase(6)
N_STAGES = W_BYTES // STAGE
SMEM_BYTES = 1024 + feat_off(5) + 8 * 8  # rdb_tc_smem_bytes


def sw128(addr):
    """128B swizzle of a byte address in a 1024-byte aligned buffer."""
    return addr ^ (((addr >> 7) & 7) << 4)


def a_chunk(j, p, q):
    """The 16-byte chunk of feature j's window where chunk q of pixel p lies:
    swz(p, q, 8) (TMA's swizzle) for x, swz(p, q, 4) for x_1..x_4."""
    return p * 8 + (q ^ (p & 7)) if j == 0 else p * 4 + (q ^ ((p >> 1) & 3))


def k_steps(k):
    """Conv k's k-steps in the consumers' order: (tap, source j, first
    channel of j, byte offset of the k-block in the image, K offset in it)."""
    ks = cin(k) // 16
    for tap in range(9):
        for cs in range(ks):
            s = tap * ks + cs
            j, c0 = (0, 16 * cs) if cs < 4 else (1 + (cs - 4) // 2, 16 * ((cs - 4) % 2))
            yield tap, j, c0, wbase(k) + (s >> 2) * kblock_bytes(k), (s & 3) * 32


def group_mtiles(k, g):
    """Warpgroup g's M-tiles of conv k: g, g + GROUPS, ..; the first
    (M-tiles % GROUPS) groups take one more."""
    lo, rem = divmod(mtiles(k), GROUPS)
    return [GROUPS * i + g for i in range(lo + (g < rem))]


def _params(seed):
    rng = np.random.default_rng(seed)
    p = {}
    for k in range(1, 6):
        p[f"w{k}"] = torch.from_numpy(
            (rng.standard_normal((3, 3, cin(k), cout(k))) * (2.0 / (9 * cin(k))) ** 0.5).astype(np.float32))
        p[f"b{k}"] = torch.from_numpy((0.1 * rng.standard_normal(cout(k))).astype(np.float32))
    return p


# -- layouts -------------------------------------------------------------------


def test_weight_image_decodes_to_hwio():
    """Each k-step's B operand, read the way the kernel's descriptor reads it
    (row n at 128 n bytes of its k-block, K step at 32 bytes, swizzled by
    address), is w_k[ty, tx, the step's 16 channels, :] transposed, exactly;
    the k-blocks' padding is zero; the bf16 layout is the image of the
    bf16-rounded weights."""
    p = _params(3)
    img = rdb_conv.rdb5c_weight_image(p)
    assert img.numel() * 2 == W_BYTES == 483328 and N_STAGES == 59
    kk = torch.arange(16)[None, :]
    read = torch.zeros(img.numel(), dtype=torch.bool)
    for k in range(1, 6):
        n = torch.arange(cout(k))[:, None]
        concat_off = [0] + [NF + GC * (i - 1) for i in range(1, k)]
        for tap, j, c0, kb, koff in k_steps(k):
            idx = sw128(kb + n * 128 + koff + kk * 2) // 2  # [N, 16]
            want = p[f"w{k}"][tap // 3, tap % 3, concat_off[j] + c0: concat_off[j] + c0 + 16, :].T
            assert torch.equal(img[idx], want), (k, tap, j, c0)
            assert not read[idx].any()
            read[idx] = True
    assert not img[~read].any()  # only padding is never read, and it is zero
    assert (~read).sum().item() == 2 * 32 * GC  # conv 2's and conv 4's half k-blocks
    bf = rdb_conv.rdb5c_kernel_weights(p, torch.bfloat16, torch.device("cpu"))
    assert len(bf.wts) == 1 and bf.wts[0].dtype == torch.bfloat16
    assert torch.equal(bf.wts[0].float(), rdb_conv.rdb5c_weight_image(
        {k: v.bfloat16().float() for k, v in p.items()}))


def test_stage_schedule_producer_equals_consumers():
    """The producer copies stages 0..58 in order, stage t to slot t % 3. The
    consumers' k-steps touch the same stages in the same order (each first
    touch waits on the slot's full barrier), every k-block lies inside its
    stage, every (conv, source, tap) comes once with all its channels, and
    each stage is released once, after its last read (the kernel's
    ``fresh`` logic and the release at the tile's end)."""
    producer = [(t, t * STAGE, t % SLOTS) for t in range(N_STAGES)]
    touched, seen, cur, released = [], {}, -1, []
    for k in range(1, 6):
        for step, (tap, j, c0, kb, koff) in enumerate(k_steps(k)):
            st = kb // STAGE
            assert kb % STAGE + kblock_bytes(k) <= STAGE  # the k-block fits its slot
            assert koff + 32 <= 128
            if st != cur:
                touched.append((st, st * STAGE, st % SLOTS))
                if cur >= 0:
                    released.append(cur)
                cur = st
            seen.setdefault((k, j, tap), []).append(c0)
            assert step < 9 * cin(k) // 16
    released.append(cur)  # at the tile's end
    assert touched == producer
    assert released == list(range(N_STAGES))
    for k in range(1, 6):
        for j in range(k):
            for tap in range(9):
                assert sorted(seen.pop((k, j, tap))) == list(range(0, chunks(j) * 8, 16))
    assert not seen
    assert max(kblock_bytes(k) for k in range(1, 6)) <= STAGE
    assert feat_off(0) % 1024 == 0  # the TMA window and the ring slots are 1024-aligned
    assert feat_off(5) - feat_off(0) == 200704
    assert SMEM_BYTES <= SMEM_LIMIT


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_mtiles_cover_each_pixel_once(k):
    """The consumer warpgroups' M-tiles: the A rows (warp w, lane l: row 16 w + l %
    16) and the accumulators (rows 16 w + l / 4 + 8 hf, channels 8 jn + 2 (l
    % 4) + e) cover every (pixel, channel) of conv k's output region once."""
    npx, n = out_edge(k) ** 2, cout(k)
    rows, cells = [], []
    for g in range(GROUPS):
        for mi in group_mtiles(k, g):
            for w4 in range(4):
                rows += [mi * 64 + 16 * w4 + ln for ln in range(16)]
                for lane in range(32):
                    for hf in range(2):
                        p = mi * 64 + 16 * w4 + lane // 4 + 8 * hf
                        cells += [(p, 8 * jn + 2 * (lane % 4) + e) for jn in range(n // 8) for e in range(2)]
    assert sorted(r for r in rows if r < npx) == list(range(npx))
    assert len(rows) == 64 * mtiles(k) and len(set(rows)) == len(rows)
    live = sorted(c for c in cells if c[0] < npx)
    assert live == [(p, c) for p in range(npx) for c in range(n)]
    counts = [len(group_mtiles(k, g)) for g in range(GROUPS)]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def _width_params(nf, gc, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for k in range(1, 6):
        ci, co = nf + (k - 1) * gc, nf if k == 5 else gc
        p[f"w{k}"] = torch.from_numpy((rng.standard_normal((3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5).astype(np.float32))
        p[f"b{k}"] = torch.from_numpy((0.1 * rng.standard_normal(co)).astype(np.float32))
    return p


@pytest.mark.parametrize("nf,gc", [(8, 4), (16, 8), (12, 6)])
def test_bf16_tiles_are_hints_and_other_widths_take_simt(nf, gc):
    """bf16 tiles are a schedule hint (no tile raises; the tensor-core kernel
    runs 16 x 16 whatever is asked), nf 64 / gc 32 takes the tensor-core
    image, and every other bf16 width the SIMT layout: each conv's
    [9][cin_pad][cout_pad] with the HWIO weights in their place, zero rows and
    columns (and zero bias) in the padding to multiples of 8 channels. The
    padded block, run on x padded with zero channels, is the block."""
    p = _params(4)
    x = torch.zeros(1, 8, 8, NF, dtype=torch.bfloat16)
    for strip, wtile in ((8, 8), (12, 8), (16, 12), (16, 16)):
        assert rdb_conv.fused_rdb5c_tiled(x, p, strip=strip, wtile=wtile).shape == x.shape
    assert rdb_conv.rdb5c_kernel_weights(p, torch.bfloat16, torch.device("cpu")).route == "tc"
    q = _width_params(nf, gc, seed=nf + gc)
    kw = rdb_conv.rdb5c_kernel_weights(q, torch.bfloat16, torch.device("cpu"))
    nf_p, gc_p = -(-nf // 8) * 8, -(-gc // 8) * 8
    assert (kw.route, kw.nf, kw.gc, kw.nf_pad, kw.gc_pad) == ("simt", nf, gc, nf_p, gc_p)
    padded = {}
    for k in range(1, 6):
        w, b = kw.wts[k - 1], kw.bs[k - 1]
        cout_p = nf_p if k == 5 else gc_p
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == (9, nf_p + (k - 1) * gc_p, cout_p)
        assert b.dtype == torch.float32 and tuple(b.shape) == (cout_p,)
        want = q[f"w{k}"].reshape(9, -1, q[f"w{k}"].shape[-1]).bfloat16()
        rows = [r for j in range(k) for r in (range(nf) if j == 0 else range(nf_p + (j - 1) * gc_p,
                                                                                nf_p + (j - 1) * gc_p + gc))]
        cout = nf if k == 5 else gc
        assert torch.equal(w[:, rows, :cout], want)
        mask = torch.ones_like(w, dtype=torch.bool)
        mask[:, rows, :cout] = False
        assert not w[mask].any() and not b[cout:].any()
        assert torch.equal(b[:cout], q[f"b{k}"])
        padded[f"w{k}"] = w.float().reshape(3, 3, -1, cout_p)
        padded[f"b{k}"] = b
    xs = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 9, 11, nf)).astype(np.float32))
    got = rdb_conv.rdb5c_reference(torch.nn.functional.pad(xs, (0, nf_p - nf)), padded)
    assert not got[..., nf:].any()
    want = rdb_conv.rdb5c_reference(xs, {k: v.bfloat16().float() if k[0] == "w" else v for k, v in q.items()})
    torch.testing.assert_close(got[..., :nf], want, atol=ATOL, rtol=0)
    kw32 = rdb_conv.rdb5c_kernel_weights(q, torch.float32, torch.device("cpu"))
    assert kw32.route == "simt" and kw32.wts[0].dtype == torch.float32 and kw32.nf_pad == nf_p


# -- the kernel's work, emulated ---------------------------------------------------


def _tma_window(smem, x, n, gy0, gx0):
    """The 26 x 26 x 64 box at (gy0, gx0), zero outside the image, 128B-swizzled
    at the x window's (1024-aligned) offset."""
    _, h, w, _ = x.shape
    box = torch.zeros(WIN, WIN, NF)
    ys, xs = slice(max(gy0, 0), min(gy0 + WIN, h)), slice(max(gx0, 0), min(gx0 + WIN, w))
    box[ys.start - gy0:ys.stop - gy0, xs.start - gx0:xs.stop - gx0] = x[n, ys, xs]
    p = torch.arange(WIN * WIN)[:, None]
    c = torch.arange(NF)[None, :]
    smem[sw128(feat_off(0) + p * 128 + 2 * c) // 2] = box.reshape(-1, NF)


def _conv(smem, ring, img, k):
    """Conv k's implicit GEMM over the A rows of all warpgroups: acc [rows, cout_k]."""
    o = out_edge(k)
    rows = torch.tensor([mi * 64 + r for g in range(GROUPS) for mi in group_mtiles(k, g) for r in range(64)])
    pc = torch.where(rows < o * o, rows, 0)  # rows past the region read pixel 0
    r, c = (pc // o)[:, None], (pc % o)[:, None]
    kk = torch.arange(16)[None, :]
    n = torch.arange(cout(k))[:, None]
    acc = torch.zeros(len(rows), cout(k))
    for tap, j, c0, kb, koff in k_steps(k):
        s = k - 1 - j
        p = (r + s + tap // 3) * edge(j) + c + s + tap % 3
        a_op = smem[(feat_off(j) + a_chunk(j, p, c0 // 8 + kk // 8) * 16 + (kk % 8) * 2) // 2]
        st = kb // STAGE
        if ring.get(st % SLOTS) != st:  # the producer's copy of stage st into its slot
            smem[(st % SLOTS) * STAGE // 2:(st % SLOTS + 1) * STAGE // 2] = img[st * STAGE // 2:(st + 1) * STAGE // 2]
            ring[st % SLOTS] = st
        b_op = smem[sw128((st % SLOTS) * STAGE + kb % STAGE + koff + n * 128 + kk * 2) // 2]
        acc += a_op @ b_op.T
    return rows, acc


def _epilogue(smem, out, rows, acc, bias, k, n, y0, x0, rezero=True):
    _, h, w, _ = out.shape
    o = out_edge(k)
    live = rows < o * o
    p, v = rows[live][:, None], acc[live] + bias
    col = torch.arange(cout(k))[None, :]
    r, c = p // o, p % o
    if k < 5:
        gy, gx = y0 - 5 + k + r, x0 - 5 + k + c
        v = torch.where(v >= 0, v, 0.2 * v)
        if rezero:  # SAME padding of the next conv: zero outside the image
            v = torch.where((gy >= 0) & (gy < h) & (gx >= 0) & (gx < w), v, 0.0)
        smem[(feat_off(k) + p * 64 + ((col // 8) ^ ((p >> 1) & 3)) * 16 + (col % 8) * 2) // 2] = v
    else:
        gy, gx = y0 + r, x0 + c
        xw = (r + 5) * WIN + c + 5
        xv = smem[(feat_off(0) + xw * 128 + ((col // 8) ^ (xw & 7)) * 16 + (col % 8) * 2) // 2]
        keep = ((gy < h) & (gx < w))[:, 0]
        out[n, gy[keep, 0], gx[keep, 0]] = (xv + 0.2 * v)[keep]


def _emulate(x, p, grid, rezero=True):
    """rdb5c_tc_kernel's work, step by step, in f32: blocks b < grid walk the
    tiles b, b + grid, ..; shared memory starts as NaN, so a read of a pixel
    no thread wrote shows."""
    n_img, h, w, _ = x.shape
    img = rdb_conv.rdb5c_weight_image(p)
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    n_tiles = n_img * tiles_x * tiles_y
    out = torch.full_like(x, float("nan"))
    for blk in range(grid):
        smem = torch.full((SMEM_BYTES // 2,), float("nan"))
        ring = {}
        for t in range(blk, n_tiles, grid):
            n, r = divmod(t, tiles_x * tiles_y)
            y0, x0 = (r // tiles_x) * TILE, (r % tiles_x) * TILE
            _tma_window(smem, x, n, y0 - 5, x0 - 5)
            for k in range(1, 6):
                rows, acc = _conv(smem, ring, img, k)
                _epilogue(smem, out, rows, acc, p[f"b{k}"], k, n, y0, x0, rezero)
    return out


@pytest.mark.parametrize(
    "shape,grid",
    [((2, 37, 53), 5), ((1, 16, 40), 2), ((1, 5, 7), 1), ((1, 33, 18), 4)],
    ids=["ragged", "b1", "smaller-than-a-tile", "h-w-not-tile-multiples"],
)
def test_emulated_tile_walk_matches_reference(shape, grid):
    p = _params(sum(shape))
    x = torch.from_numpy(np.random.default_rng(len(shape) + grid).standard_normal(shape + (NF,)).astype(np.float32))
    got = _emulate(x, p, grid)
    assert not torch.isnan(got).any()  # every output pixel written, from written pixels only
    torch.testing.assert_close(got, rdb_conv.rdb5c_reference(x, p), atol=ATOL, rtol=0)


def test_emulation_sees_the_image_edge_rezeroing():
    """Without the re-zeroing of x_1..x_4 outside the image the same walk is
    far off at the image edge: the comparison above can see that fault."""
    shape = (1, 16, 40)
    p = _params(sum(shape))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape + (NF,)).astype(np.float32))
    off = (_emulate(x, p, 2, rezero=False) - rdb_conv.rdb5c_reference(x, p)).abs().max().item()
    assert off > 100 * ATOL
