"""The bf16 conv kernel's layouts and tiling (csrc/conv3x3.cuh), held on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
tests/test_torch_card_*.py). What surrounds it is plain index arithmetic, mirrored here in
Python from the CUDA source and checked without a GPU:

- the weight image that ``conv_kernel_weights`` builds decodes back to the
  HWIO kernel through the kernel's wgmma descriptor addressing (a block's
  weights at (parity row, Cout slice), then K chunk, parity and tap; the
  128-byte swizzle included), at every width the bf16 route takes; f32 takes
  the f32 kernel's layout (tests/test_torch_f32_conv.py decodes it), and a
  bf16 conv wider than the kernel takes raises;
- the 128B swizzle that TMA writes and wgmma reads equals ``swz(p, q, 8)``
  of common.cuh, which the ldmatrix path addresses;
- a plain emulation of the kernel's work (persistent walk of the blocks'
  roles, slice-minor, over the tiles; the window of each tile, K chunk and
  parity, zero fill outside the image and beyond Cin; one GEMM per chunk
  and tap over the weight image; virtual pixels, the staging and the TMA
  store at its channel offset through the output's tensor map; the
  pixels-as-M path for Cout <= 8) equals ``conv3x3_reference`` and
  ``upsample2x_conv3x3_reference`` in f32 on ragged shapes.

f32 throughout, inputs from numpy seeds; tolerance 1e-5 (one conv, K <= 9 x
64 terms summed in another order).
"""

import numpy as np
import pytest
import torch

from esr_tpu_torch.ops.cuda import kpack_conv
from esr_tpu_torch.ops.fused import upsample2x_conv3x3_reference

torch.set_num_threads(1)

CONV_ATOL = 1e-5
TILE, WIN = 16, 18  # kTile, kWin
WIN_STRIDE = (WIN * WIN * 128 + 1023) // 1024 * 1024  # kWinStride, bytes
VIRT = TILE // 2 * WIN  # kVirt: a warpgroup's virtual pixels


def sw128(addr):
    """128B swizzle of a byte address in a 1024-byte aligned buffer: the
    16-byte chunk (bits 4..6) XOR the 128-byte row's phase (bits 7..9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def swz(p, q, ch):
    """common.cuh swz: element offset of 16-byte chunk q of pixel p, ch chunks a pixel."""
    s = p & 7 if ch >= 8 else ((p * ch) >> 3) & (ch - 1)
    return (p * ch + (q ^ s)) * 8


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _case(shape, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal(shape + (cin,)))
    w = _t(rng.standard_normal((3, 3, cin, cout)) * (2.0 / (9 * cin)) ** 0.5)
    b = _t(0.1 * rng.standard_normal(cout))
    return x, w, b


# -- layouts -------------------------------------------------------------------


def _per_tap(w, ksize):
    """HWIO (3, 3, Cin, Cout) -> the per-tap weights [parities, taps, Cin, Cout] of a mode."""
    cin, cout = w.shape[2:]
    return w.reshape(1, 9, cin, cout) if ksize == 3 else kpack_conv.parity_kernels(w).reshape(4, 4, cin, cout)


def _decode(image, par, taps, cin_pad, cout_pad):
    """The tensor-core weight image read as the kernel reads it: block (parity
    row a, slice j) copies its bytes from ((a * S + j) * KC ...) on, and the
    operand of (K chunk c, parity b, tap) starts at ((c * P + b) * taps +
    tap) * N * 128 bytes into them; row n at 128 n bytes, K step kb at 32 kb,
    swizzled by address. -> [parities, taps, 64 KC, Cout_pad]."""
    n_blk = 8 if cout_pad == 8 else 64
    slices, kc = cout_pad // n_blk, max(cin_pad // 64, 1)
    rows, pp = (2, 2) if par == 4 else (1, 1)
    flat = image.reshape(-1)
    k = torch.arange(64)[:, None]
    n = torch.arange(n_blk)[None, :]
    out = torch.full((par, taps, 64 * kc, cout_pad), float("nan"))
    block_bytes = kc * pp * taps * n_blk * 128
    for a in range(rows):
        for j in range(slices):
            for c in range(kc):
                for b in range(pp):
                    for tap in range(taps):
                        start = (a * slices + j) * block_bytes + ((c * pp + b) * taps + tap) * n_blk * 128
                        got = flat[sw128(start + n * 128 + (k // 16) * 32 + (k % 16) * 2) // 2]  # [K, N]
                        out[a * pp + b, tap, 64 * c:64 * c + 64, j * n_blk:(j + 1) * n_blk] = got
    assert flat.numel() == rows * slices * block_bytes // 2  # nothing else in the image
    return out


def _expected_pads(cin, cout):
    return (16 if cin <= 16 else 64 * -(-cin // 64)), (8 if cout <= 8 else 64 * -(-cout // 64))


@pytest.mark.parametrize("ksize", [3, 2])
@pytest.mark.parametrize("cin,cout", [(64, 64), (4, 64), (64, 3), (64, 256), (128, 128), (96, 3), (64, 96)])
def test_weight_image_decodes_to_hwio(cin, cout, ksize):
    """Each (slice, K chunk, parity, tap) A operand (Cout above 8) or B
    operand (Cout <= 8), read the way the kernel's descriptor reads it, is
    its [64-channel K chunk, 64-channel Cout slice] of the HWIO kernel,
    exactly, with zeros in the padding."""
    _, w, _ = _case((1, 1, 1), cin, cout, seed=cin + cout + ksize)
    want = _per_tap(w, ksize)
    image, cin_pad, cout_pad = kpack_conv.wgmma_weight_image(want)
    assert (cin_pad, cout_pad) == _expected_pads(cin, cout)
    got = _decode(image, want.shape[0], want.shape[1], cin_pad, cout_pad)
    assert torch.equal(got[:, :, :cin, :cout], want)
    assert not got[:, :, cin:].any() and not got[..., cout:].any()
    bf = kpack_conv.conv_kernel_weights(w, torch.ones(cout), torch.bfloat16, torch.device("cpu"), ksize)
    assert torch.equal(bf.wt.float(), kpack_conv.wgmma_weight_image(_per_tap(w, ksize).bfloat16().float())[0])
    assert bf.bias.shape == (cout_pad,) and (bf.cin_pad, bf.cout_pad) == (cin_pad, cout_pad)


def test_sw128_is_swz_and_its_own_inverse():
    """TMA's 128B swizzle of a window pixel (128-byte rows, 1024-aligned
    stage) puts chunk q of pixel p where common.cuh's swz(p, q, 8) does, so
    the ldmatrix path reads TMA's windows; sw128_rows builds the same
    permutation and undoes itself."""
    p = torch.arange(WIN * WIN + 4)[:, None]
    q = torch.arange(8)[None, :]
    assert torch.equal(sw128(p * 128 + q * 16), swz(p, q, 8) * 2)
    rows = torch.arange(24 * 64, dtype=torch.float32).reshape(24, 64)
    img = kpack_conv.sw128_rows(rows).reshape(-1)
    c = torch.arange(64)[None, :]
    r = torch.arange(24)[:, None]
    assert torch.equal(img[sw128(r * 128 + 2 * c) // 2], rows)
    assert torch.equal(kpack_conv.sw128_rows(kpack_conv.sw128_rows(rows)), rows)


def test_stmatrix_staging_is_what_the_tma_store_reads():
    """The epilogue writes chunk c of staging slot s at s * 128 + ((c ^ (s %
    8)) << 4) (stmatrix row addresses); the TMA store reads it back with the
    128B swizzle by address."""
    s = torch.arange(TILE // 2 * TILE)[:, None]
    ch = torch.arange(64)[None, :]
    written = s * 128 + (((ch // 8) ^ (s & 7)) << 4) + (ch % 8) * 2
    assert torch.equal(written, sw128(s * 128 + 2 * ch))


@pytest.mark.parametrize("ksize", [3, 2])
@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 128), (128, 128), (96, 3)])
def test_bf16_wide_convs_take_the_tensor_core_layout(cin, cout, ksize):
    """A bf16 conv with Cin or Cout above 64 takes the tensor-core kernel's
    layout: Cin in K chunks of 64 (cin_pad 128), Cout in slices of 64 (or 8
    for Cout <= 8), the image decoding back to the bf16 HWIO kernel (or its
    parity kernels) through the slice / chunk addressing, zeros in the
    padding, the bias zero-padded to Cout_pad."""
    _, w, b = _case((1, 1, 1), cin, cout, seed=cin + cout + ksize)
    kw = kpack_conv.conv_kernel_weights(w, b, torch.bfloat16, torch.device("cpu"), ksize)
    cin_pad, cout_pad = _expected_pads(cin, cout)
    assert (kw.route, kw.cin, kw.cout, kw.cin_pad, kw.cout_pad, kw.ksize) == ("tc", cin, cout, cin_pad, cout_pad, ksize)
    want = _per_tap(w, ksize).bfloat16()
    assert kw.wt.dtype == torch.bfloat16
    got = _decode(kw.wt.float(), want.shape[0], want.shape[1], cin_pad, cout_pad)
    assert torch.equal(got[:, :, :cin, :cout], want.float())
    assert not got[:, :, cin:].any() and not got[..., cout:].any()
    assert torch.equal(kw.bias[:cout], b) and not kw.bias[cout:].any()


@pytest.mark.parametrize("ksize", [3, 2])
@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 128), (200, 3)])
def test_f32_convs_keep_the_simt_layout(cin, cout, ksize):
    """f32 convs of any width take the f32 kernel's layout (FP32 units, the
    SIMT route): [slice][chunk][parities][taps][8][N], N = 8 / 16 / 32 for a
    Cout that small and slices of 64 above, Cin in chunks of 8; the HWIO
    kernel (or its parity kernels) in place and zeros in the Cin and Cout
    padding."""
    _, w, b = _case((1, 1, 1), cin, cout, seed=cin + cout + ksize)
    kw = kpack_conv.conv_kernel_weights(w, b, torch.float32, torch.device("cpu"), ksize)
    n = 8 if cout <= 8 else 64
    slices, chunks = -(-cout // n), -(-cin // 8)
    assert (kw.route, kw.cin, kw.cout, kw.cin_pad, kw.cout_pad, kw.ksize) == (
        "f32", cin, cout, 8 * chunks, n * slices, ksize)
    want = _per_tap(w, ksize)
    par, taps = want.shape[:2]
    assert kw.wt.dtype == torch.float32 and tuple(kw.wt.shape) == (slices, chunks, par, taps, 8, n)
    got = kw.wt.permute(2, 3, 1, 4, 0, 5).reshape(par, taps, 8 * chunks, n * slices)
    assert torch.equal(got[:, :, :cin, :cout], want) and not got[:, :, cin:].any() and not got[..., cout:].any()
    assert torch.equal(kw.bias[:cout], b) and not kw.bias[cout:].any()


@pytest.mark.parametrize("ksize", [3, 2])
@pytest.mark.parametrize("cin,cout", [(129, 64), (64, 1025), (256, 256)])
def test_bf16_convs_past_the_limit_raise(cin, cout, ksize):
    """A bf16 conv wider than the tensor-core kernel takes (Cin above 128,
    Cout above 1024) raises ValueError naming the limits; nothing falls back."""
    w = torch.zeros(3, 3, cin, cout)
    with pytest.raises(ValueError, match="Cin up to 128 and Cout up to 1024"):
        kpack_conv.conv_kernel_weights(w, None, torch.bfloat16, torch.device("cpu"), ksize)


# -- the kernel's work, emulated ---------------------------------------------------


def _window(x, n, y0, x0, c0):
    """A stage after the window load of K chunk c0 / 64 of a tile: the (18,
    18, 64) box of channels c0 .. c0 + 63 from (y0 - 1, x0 - 1), zero outside
    the image and in channels >= Cin, 128B-swizzled into a flat buffer (with
    the room after it that the last virtual pixels read)."""
    _, h, w, cin = x.shape
    box = torch.zeros(WIN, WIN, 64)
    ys, xs = slice(max(y0 - 1, 0), min(y0 - 1 + WIN, h)), slice(max(x0 - 1, 0), min(x0 - 1 + WIN, w))
    live = min(cin - c0, 64)
    box[ys.start - (y0 - 1):ys.stop - (y0 - 1), xs.start - (x0 - 1):xs.stop - (x0 - 1), :live] = \
        x[n, ys, xs, c0:c0 + live]
    buf = torch.full((WIN_STRIDE // 2 + 2 * 64,), float("nan"))
    p = torch.arange(WIN * WIN)[:, None]
    c = torch.arange(64)[None, :]
    buf[sw128(p * 128 + 2 * c) // 2] = box.reshape(WIN * WIN, 64)
    buf[WIN * WIN * 64:] = 0.0  # what lies after the window: read only for dropped columns
    return buf


def _operand(flat, start, rows, kb):
    """The [rows, 16] K-major operand a descriptor at byte `start` reads for K step kb."""
    r = torch.arange(rows)[:, None]
    kk = torch.arange(16)[None, :]
    return flat[sw128(start + r * 128 + kb * 32 + kk * 2) // 2]


def _emulate(x, kw, act, grid):
    """conv_tc_kernel's work, step by step, in f32: out (N, H, W, Cout) or
    (N, 2H, 2W, Cout)."""
    n_img, h, w, _ = x.shape
    up = kw.ksize == 2
    kh, par = (2, 2) if up else (3, 1)
    n_blk = 8 if kw.cout_pad == 8 else 64
    slices = kw.cout_pad // n_blk
    kc, ks = (1, 1) if kw.cin_pad == 16 else (kw.cin_pad // 64, 4)
    roles = (2 if up else 1) * slices  # launch_tc: the grid is a multiple of the roles
    assert grid % roles == 0
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    n_tiles = n_img * tiles_x * tiles_y
    cout = kw.cout_pad if n_blk == 64 else kw.cout  # the kernel writes Cout above 8 as whole slices
    out = torch.full((n_img, (2 if up else 1) * h, (2 if up else 1) * w, cout), float("nan"))
    omap = _out_map(out, up, h, w) if n_blk == 64 else None
    flat_w = kw.wt.float().reshape(-1)
    bias = kw.bias if kw.bias is not None else torch.zeros(kw.cout_pad)
    block_bytes = kc * par * kh * kh * n_blk * 128  # conv_tc_wbytes
    for blk in range(grid):
        role = blk % roles
        pa, sl = (role & 1, role >> 1) if up else (0, role)
        t0, t_step = blk // roles, grid // roles
        w_base = (pa * slices + sl) * block_bytes  # the block's weights in the image
        for t in range(t0, n_tiles, t_step):
            n, r = divmod(t, tiles_x * tiles_y)
            y0, x0 = (r // tiles_x) * TILE, (r % tiles_x) * TILE
            wins = [_window(x, n, y0, x0, 64 * c) for c in range(kc)]
            for pb in range(par):
                # (window, tap operand start, window offset) per K chunk and tap
                steps = [(wins[c], w_base + ((c * par + pb) * kh * kh + tap) * n_blk * 128,
                          (tap // kh + pa) * WIN + tap % kh + pb) for c in range(kc) for tap in range(kh * kh)]
                if n_blk == 64:
                    _tn_unit(omap, steps, flat_w, ks, bias[64 * sl:64 * sl + 64], act, n, y0, x0, pa, pb, up, sl,
                             slices)
                else:
                    _rs_unit(out, steps, flat_w, ks, bias, act, n, y0, x0, pa, pb, up, kw.cout)
    return out[..., : kw.cout]


def _out_map(out, up, h, w):
    """launch_tc's 5-D tensor map of the output (channels, x, parity row, y,
    image) over ``out``'s storage: (flat view, dims, byte strides)."""
    c = out.shape[-1]
    px = (2 if up else 1) * c * 2
    row = w * px
    strides = (px, row, 2 * row if up else row, h * (2 if up else 1) * row)
    dims = ((2 if up else 1) * c, w, 2 if up else 1, h, out.shape[0])
    return out.view(-1), dims, strides


def _tma_store(omap, staging, coords):
    """One TMA store of an 8 x 16-pixel staging tile (64 channels, read with
    the 128B swizzle) at coords (c0, x, parity row, y, image); the parts of
    the box outside the tensor are not written."""
    flat, dims, strides = omap
    c0, x0, p, y0, n = coords
    yy, xx, cc = torch.arange(8)[:, None, None], torch.arange(TILE)[None, :, None], torch.arange(64)[None, None, :]
    vals = staging[sw128((yy * TILE + xx) * 128 + 2 * cc) // 2]
    inside = ((c0 + cc < dims[0]) & (x0 + xx < dims[1]) & (y0 + yy < dims[3])).expand(vals.shape)
    off = ((c0 + cc) * 2 + (x0 + xx) * strides[0] + p * strides[1] + (y0 + yy) * strides[2]
           + n * strides[3]) // 2
    flat[off.expand(vals.shape)[inside]] = vals[inside]


def _put(out, n, gy, gx, pa, pb, up, vals):
    """Pixel (gy, gx) of parity (pa, pb), if inside the image."""
    h, w = out.shape[1] // (2 if up else 1), out.shape[2] // (2 if up else 1)
    if gy < h and gx < w:
        oy, ox = (2 * gy + pa, 2 * gx + pb) if up else (gy, gx)
        out[n, oy, ox, : vals.shape[0]] = vals


def _epi(acc, bias, act):
    y = acc + bias
    return torch.where(y >= 0, y, 0.2 * y) if act else y


def _tn_unit(omap, steps, flat_w, ks, bias, act, n, y0, x0, pa, pb, up, sl, slices):
    """N = 64: each warpgroup's 144 virtual pixels as the wgmma N, the
    slice's weights as M, accumulated over K chunks and taps; staged as 8 x
    16 pixels, stored by TMA at channel (pb x Cout_pad +) 64 x slice."""
    for g in range(2):
        acc = torch.zeros(64, VIRT)
        for buf, w_start, off in steps:
            for kb in range(ks):
                a_op = _operand(flat_w, w_start, 64, kb)  # [64 out channels, 16]
                b_op = _operand(buf, (g * VIRT + off) * 128, VIRT, kb)  # [144 pixels, 16]
                acc += a_op @ b_op.T
        vals = _epi(acc.T, bias, act)  # [virtual pixel, channel]
        staging = torch.full((TILE // 2 * TILE * 64,), float("nan"))
        for v in range(VIRT):
            row, col = divmod(v, WIN)
            if col < TILE:  # columns 16 and 17 go to the dump row
                slot = row * TILE + col
                ch = torch.arange(64)
                staging[(slot * 128 + (((ch // 8) ^ (slot & 7)) << 4) + (ch % 8) * 2) // 2] = vals[v]
        c0 = (pb * 64 * slices if up else 0) + 64 * sl
        _tma_store(omap, staging, (c0, x0, pa if up else 0, y0 + g * (TILE // 2), n))


def _rs_unit(out, steps, flat_w, ks, bias, act, n, y0, x0, pa, pb, up, cout):
    """Cout <= 8: pixels as M (warp w of warpgroup g, m64 tile mt: tile row
    8 g + 4 mt + w, A rows by ldmatrix from swz), weights as an n8 B operand,
    accumulated over K chunks and taps."""
    for g in range(2):
        for mt in range(2):
            for w4 in range(4):
                row = g * 8 + mt * 4 + w4
                acc = torch.zeros(TILE, 8)
                for buf, w_start, off in steps:
                    for kb in range(ks):
                        p = row * WIN + torch.arange(TILE)[:, None] + off
                        kk = torch.arange(16)[None, :]
                        a_op = buf[swz(p, kb * 2 + kk // 8, 8) + kk % 8]  # [16 pixels, 16]
                        b_op = _operand(flat_w, w_start, 8, kb)  # [8, 16]
                        acc += a_op @ b_op.T
                vals = _epi(acc, bias, act)
                for i in range(TILE):
                    _put(out, n, y0 + row, x0 + i, pa, pb, up, vals[i, :cout])


@pytest.mark.parametrize(
    "shape,cin,cout,ksize,act,grid",
    [
        ((2, 19, 37), 64, 64, 3, False, 3),
        ((2, 19, 37), 64, 64, 2, True, 4),
        ((1, 16, 16), 4, 64, 3, False, 1),
        ((1, 21, 9), 4, 64, 2, True, 2),
        ((2, 19, 37), 64, 3, 3, False, 5),
        ((1, 17, 20), 64, 3, 2, True, 2),
        ((1, 18, 18), 16, 32, 3, True, 2),
        ((1, 19, 21), 64, 256, 3, True, 8),
        ((1, 21, 19), 64, 576, 3, False, 18),
        ((1, 19, 21), 128, 128, 3, True, 6),
        ((1, 17, 23), 128, 128, 2, True, 8),
        ((2, 9, 19), 64, 96, 3, True, 4),
        ((1, 19, 17), 96, 3, 3, False, 3),
    ],
    ids=["3x3-64", "2x2-64", "3x3-cin4-b1", "2x2-cin4", "3x3-cout3", "2x2-cout3", "3x3-cout32",
         "3x3-64to256", "3x3-64to576", "3x3-128", "2x2-128", "3x3-64to96", "3x3-96to3"],
)
def test_emulated_kernel_tiling_matches_plain(shape, cin, cout, ksize, act, grid):
    x, w, b = _case(shape, cin, cout, seed=sum(shape) + cin + cout + ksize)
    kw = kpack_conv.conv_kernel_weights(w, b, torch.float32, torch.device("cpu"))
    image, cin_pad, cout_pad = kpack_conv.wgmma_weight_image(_per_tap(w, ksize))
    kw = kw._replace(wt=image, ksize=ksize, cin_pad=cin_pad, cout_pad=cout_pad,
                     bias=torch.nn.functional.pad(b, (0, cout_pad - cout)))
    got = _emulate(x, kw, act, grid)
    plain = kpack_conv.conv3x3_reference if ksize == 3 else upsample2x_conv3x3_reference
    want = plain(x, w, b, act)
    assert got.shape == want.shape
    assert not torch.isnan(got).any()  # every output pixel written exactly where it belongs
    torch.testing.assert_close(got, want, atol=CONV_ATOL, rtol=0)
