"""The bf16 conv kernel's layouts and tiling (csrc/conv3x3.cuh), held on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py). What surrounds it is plain index arithmetic, mirrored here in
Python from the CUDA source and checked without a GPU:

- the weight image that ``conv_kernel_weights`` builds decodes back to the
  HWIO kernel through the kernel's wgmma descriptor addressing (128-byte
  swizzle included);
- the 128B swizzle that TMA writes and wgmma reads equals ``swz(p, q, 8)``
  of common.cuh, which the ldmatrix path addresses;
- a plain emulation of the kernel's work (persistent tile walk, the window
  of each tile and parity, zero fill outside the image, one GEMM per tap
  over the weight image, virtual pixels and the staging / TMA store, the
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


@pytest.mark.parametrize("ksize", [3, 2])
@pytest.mark.parametrize("cin,cout", [(64, 64), (4, 64), (64, 3)])
def test_weight_image_decodes_to_hwio(cin, cout, ksize):
    """Each tap's B (Cout <= 8) or A (Cout 64) operand, read the way the
    kernel's descriptor reads it (row n at 128 n bytes, K step kb at 32 kb
    bytes, swizzled by address), is the HWIO kernel's [Cin, Cout] slice,
    exactly, with zeros in the padding."""
    _, w, _ = _case((1, 1, 1), cin, cout, seed=cin + cout + ksize)
    image, cin_pad, cout_pad = kpack_conv.wgmma_weight_image(
        w.reshape(1, 9, cin, cout) if ksize == 3 else kpack_conv.parity_kernels(w).reshape(4, 4, cin, cout))
    assert (cin_pad, cout_pad) == ((16 if cin <= 16 else 64), (8 if cout <= 8 else 64))
    flat = image.reshape(-1)
    taps = 9 if ksize == 3 else 16
    want = w.reshape(9, cin, cout) if ksize == 3 else kpack_conv.parity_kernels(w).reshape(16, cin, cout)
    k = torch.arange(64)[:, None]
    n = torch.arange(cout_pad)[None, :]
    for tap in range(taps):
        start = tap * cout_pad * 128
        got = flat[sw128(start + n * 128 + (k // 16) * 32 + (k % 16) * 2) // 2]  # [K, N]
        assert torch.equal(got[:cin, :cout], want[tap]), tap
        assert not got[cin:].any() and not got[:, cout:].any()
    bf = kpack_conv.conv_kernel_weights(w, torch.ones(cout), torch.bfloat16, torch.device("cpu"), ksize)
    assert torch.equal(bf.wt.float(), kpack_conv.wgmma_weight_image(
        w.bfloat16().float().reshape(1, 9, cin, cout) if ksize == 3
        else kpack_conv.parity_kernels(w).bfloat16().float().reshape(4, 4, cin, cout))[0])
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
def test_bf16_wide_convs_take_the_simt_layout(cin, cout, ksize):
    """A bf16 conv with Cin or Cout above 64 takes the SIMT kernel's layout
    (the tensor-core image refuses it): [parities][taps][Cin][Cout_pad] in
    bf16, the HWIO kernel (or its parity kernels) in place and zeros in the
    Cout padding to a multiple of 8; bf16 convs up to 64 keep the tensor-core
    route."""
    _, w, b = _case((1, 1, 1), cin, cout, seed=cin + cout + ksize)
    with pytest.raises(ValueError, match="up to 64"):
        kpack_conv.wgmma_weight_image(w.reshape(1, 9, cin, cout))
    kw = kpack_conv.conv_kernel_weights(w, b, torch.bfloat16, torch.device("cpu"), ksize)
    cout_pad = -(-cout // 8) * 8
    assert (kw.route, kw.cin, kw.cout, kw.cout_pad, kw.ksize) == ("simt", cin, cout, cout_pad, ksize)
    want = w.reshape(1, 9, cin, cout) if ksize == 3 else kpack_conv.parity_kernels(w).reshape(4, 4, cin, cout)
    assert kw.wt.dtype == torch.bfloat16 and tuple(kw.wt.shape) == tuple(want.shape[:3]) + (cout_pad,)
    assert torch.equal(kw.wt[..., :cout], want.bfloat16()) and not kw.wt[..., cout:].any()
    assert torch.equal(kw.bias[:cout], b) and not kw.bias[cout:].any()
    assert kpack_conv.conv_kernel_weights(w[:, :, :64, :64], b[:64], torch.bfloat16, torch.device("cpu"),
                                          ksize).route == "tc"


# -- the kernel's work, emulated ---------------------------------------------------


def _window(x, n, y0, x0):
    """A stage after the tile's window load: the (18, 18, 64) box from (y0 -
    1, x0 - 1), zero outside the image and in channels >= Cin, 128B-swizzled
    into a flat buffer (with the room after it that the last virtual pixels
    read)."""
    _, h, w, cin = x.shape
    box = torch.zeros(WIN, WIN, 64)
    ys, xs = slice(max(y0 - 1, 0), min(y0 - 1 + WIN, h)), slice(max(x0 - 1, 0), min(x0 - 1 + WIN, w))
    box[ys.start - (y0 - 1):ys.stop - (y0 - 1), xs.start - (x0 - 1):xs.stop - (x0 - 1), :cin] = x[n, ys, xs]
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
    kh, n_pad, ks = (2 if up else 3), kw.cout_pad, kw.cin_pad // 16
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    n_tiles = n_img * tiles_x * tiles_y
    cout = n_pad if n_pad == 64 else kw.cout  # the kernel writes 8 < Cout < 64 as 64 channels
    out = torch.full((n_img, (2 if up else 1) * h, (2 if up else 1) * w, cout), float("nan"))
    flat_w = kw.wt.float().reshape(-1)
    bias = kw.bias if kw.bias is not None else torch.zeros(n_pad)
    par = 2 if up else 1
    for blk in range(grid):
        pa = blk % 2 if up else 0
        t0, t_step = (blk // 2, grid // 2) if up else (blk, grid)
        w_base = pa * par * kh * kh  # the block's first tap matrix in the image
        for t in range(t0, n_tiles, t_step):
            n, r = divmod(t, tiles_x * tiles_y)
            y0, x0 = (r // tiles_x) * TILE, (r % tiles_x) * TILE
            buf = _window(x, n, y0, x0)
            for pb in range(par):
                taps = [(w_base + pb * kh * kh + tap, (tap // kh + pa) * WIN + tap % kh + pb)
                        for tap in range(kh * kh)]
                if n_pad == 64:
                    _tn_unit(out, buf, flat_w, taps, ks, bias, act, n, y0, x0, pa, pb, up)
                else:
                    _rs_unit(out, buf, flat_w, taps, ks, bias, act, n, y0, x0, pa, pb, up, kw.cout)
    return out[..., : kw.cout]


def _put(out, n, gy, gx, pa, pb, up, vals):
    """Pixel (gy, gx) of parity (pa, pb), if inside the image."""
    h, w = out.shape[1] // (2 if up else 1), out.shape[2] // (2 if up else 1)
    if gy < h and gx < w:
        oy, ox = (2 * gy + pa, 2 * gx + pb) if up else (gy, gx)
        out[n, oy, ox, : vals.shape[0]] = vals


def _epi(acc, bias, act):
    y = acc + bias
    return torch.where(y >= 0, y, 0.2 * y) if act else y


def _tn_unit(out, buf, flat_w, taps, ks, bias, act, n, y0, x0, pa, pb, up):
    """Cout 64: each warpgroup's 144 virtual pixels as the wgmma N, weights
    as M; staged as 8 x 16 pixels, stored by TMA (clipped to the image)."""
    for g in range(2):
        acc = torch.zeros(64, VIRT)
        for tap_m, off in taps:
            for kb in range(ks):
                a_op = _operand(flat_w, tap_m * 64 * 128, 64, kb)  # [64 out channels, 16]
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
        for slot in range(TILE // 2 * TILE):
            row, col = divmod(slot, TILE)
            ch = torch.arange(64)
            _put(out, n, y0 + g * 8 + row, x0 + col, pa, pb, up, staging[sw128(slot * 128 + 2 * ch) // 2])


def _rs_unit(out, buf, flat_w, taps, ks, bias, act, n, y0, x0, pa, pb, up, cout):
    """Cout <= 8: pixels as M (warp w of warpgroup g, m64 tile mt: tile row
    8 g + 4 mt + w, A rows by ldmatrix from swz), weights as an n8 B operand."""
    for g in range(2):
        for mt in range(2):
            for w4 in range(4):
                row = g * 8 + mt * 4 + w4
                acc = torch.zeros(TILE, 8)
                for tap_m, off in taps:
                    for kb in range(ks):
                        p = row * WIN + torch.arange(TILE)[:, None] + off
                        kk = torch.arange(16)[None, :]
                        a_op = buf[swz(p, kb * 2 + kk // 8, 8) + kk % 8]  # [16 pixels, 16]
                        b_op = _operand(flat_w, tap_m * 8 * 128, 8, kb)  # [8, 16]
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
    ],
    ids=["3x3-64", "2x2-64", "3x3-cin4-b1", "2x2-cin4", "3x3-cout3", "2x2-cout3", "3x3-cout32"],
)
def test_emulated_kernel_tiling_matches_plain(shape, cin, cout, ksize, act, grid):
    x, w, b = _case(shape, cin, cout, seed=sum(shape) + cin + cout + ksize)
    kw = kpack_conv.conv_kernel_weights(w, b, torch.float32, torch.device("cpu"))
    image, cin_pad, cout_pad = kpack_conv.wgmma_weight_image(
        w.reshape(1, 9, cin, cout) if ksize == 3 else kpack_conv.parity_kernels(w).reshape(4, 4, cin, cout))
    kw = kw._replace(wt=image, ksize=ksize, cin_pad=cin_pad, cout_pad=cout_pad,
                     bias=torch.nn.functional.pad(b, (0, cout_pad - cout)))
    got = _emulate(x, kw, act, grid)
    plain = kpack_conv.conv3x3_reference if ksize == 3 else upsample2x_conv3x3_reference
    want = plain(x, w, b, act)
    assert got.shape == want.shape
    assert not torch.isnan(got).any()  # every output pixel written exactly where it belongs
    torch.testing.assert_close(got, want, atol=CONV_ATOL, rtol=0)
