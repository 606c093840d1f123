"""The f32 conv kernel's layouts and work (csrc/conv_f32.cuh), held on the CPU,
and the f32 RDB composed of five of its launches (ops/cuda/rdb_conv.py).

The kernel, ``conv_f32_kernel``, runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py). What surrounds it is index arithmetic, mirrored here in
Python from the CUDA source and checked without a GPU:

- the weight layout that ``conv_kernel_weights`` builds for f32 decodes back
  to the HWIO kernel (or its parity kernels) through the kernel's addressing
  ([slice][chunk][parity][tap][8][N]), zeros in the padding, at narrow and
  wide Cin and Cout;
- an f32 emulation of the kernel's walk (blocks over tiles and Cout slices,
  slice-minor; per 8-channel K chunk a window copied element by element with
  zero fill outside the image and beyond Cin, from two concatenated sources;
  each thread's 8 pixels x 8 channels read through the window's row and
  plane pitches and the weights' [parity][tap][8][N] layout; the four
  parities of the 2x2 mode from one window; the epilogue's bias, lrelu,
  residual and masked stores at a channel offset) equals
  ``conv3x3_reference`` / ``upsample2x_conv3x3_reference`` on ragged shapes,
  batch 1 and images smaller than a tile;
- the f32 RDB as five such launches through one scratch tensor
  (``rdb_conv._rdb5c_f32``, the function the card runs, fed the emulation)
  equals ``rdb5c_reference`` and, on JAX's own weights, the Pallas kernel in
  interpret mode.

f32 throughout, inputs from numpy seeds. Tolerances: one conv 1e-5 (K <= 9 x
256 terms summed in another order); the RDB against ``rdb5c_reference`` 1e-5
(five chained convs, K <= 9 x 48 at these widths), against the Pallas kernel
2e-4 (tests/test_torch_kernels.py's tolerance for that comparison).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.models.blocks import ResidualDenseBlock5C
from esr_tpu.ops.pallas.rdb_conv import fused_rdb5c as jax_fused_rdb5c
from esr_tpu.ops.pallas.rdb_conv import rdb5c_params_from_flax
from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv
from esr_tpu_torch.ops.fused import upsample2x_conv3x3_reference

torch.set_num_threads(1)

CONV_ATOL = 1e-5
RDB_ATOL = 1e-5
PALLAS_ATOL = 2e-4  # tests/test_torch_kernels.py's tolerance for the Pallas block
KC = 8  # kF32Kc


def stages(n):
    """f32_stages: the cp.async ring's stages of the N-wide instance."""
    return 2 if n <= 32 else 3


# -- the kernel's constants (conv_f32.cuh), mirrored --------------------------------


def geo(up):
    """F32Geo<UP>: tile, taps, parities, window rows / cols, row and plane pitch."""
    th = 8 if up else 16
    kh, par = (2, 4) if up else (3, 1)
    wr = wc = th + 2
    ws = (wc + 3) // 4 * 4
    return {"TH": th, "TW": th, "KH": kh, "PAR": par, "WR": wr, "WC": wc, "WS": ws, "PS": wr * ws + 4}


def smem_bytes(n, up):
    """conv_f32_smem_bytes: the ring of window + weight stages."""
    g = geo(up)
    return stages(n) * (KC * g["PS"] + g["PAR"] * g["KH"] ** 2 * KC * n) * 4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _case(shape, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal(shape + (cin,)))
    w = _t(rng.standard_normal((3, 3, cin, cout)) * (2.0 / (9 * cin)) ** 0.5)
    b = _t(0.1 * rng.standard_normal(cout))
    return x, w, b


def _per_tap(w, ksize):
    cin, cout = w.shape[2], w.shape[3]
    return w.reshape(1, 9, cin, cout) if ksize == 3 else kpack_conv.parity_kernels(w).reshape(4, 4, cin, cout)


def test_mirrored_constants():
    """The geometry the kernel is designed around: 16-byte aligned window rows
    and planes, plane pitches that spread a copy's 8 channels over the banks,
    the 10 floats a thread reads per row inside the padded row, and a ring
    that leaves room for two (N 64) to eight (N 8) blocks an SM."""
    for up in (False, True):
        g = geo(up)
        assert g["WS"] % 4 == 0 and g["PS"] % 4 == 0 and g["PS"] % 32 in (12, 28)
        c0_max = 0 if up else 8
        assert c0_max + 10 <= g["WS"]  # 16 + 16 + 8 bytes read from the first pixel's column
        assert g["TH"] * (g["TW"] // 8) * g["PAR"] == 32  # 8-pixel groups: 4 N threads / (N / 8)
        for n, per_sm in ((64, 2), (32, 5), (16, 6), (8, 8)):
            assert per_sm * (smem_bytes(n, up) + 1024) <= 233472, (n, up)


# -- the weight layout ----------------------------------------------------------------


@pytest.mark.parametrize("ksize", [3, 2])
@pytest.mark.parametrize("cin,cout", [(4, 64), (3, 3), (64, 3), (12, 20), (64, 32), (192, 96), (256, 256)])
def test_f32_layout_decodes_to_hwio(cin, cout, ksize):
    """conv_kernel_weights in f32: [slice][chunk][parity][tap][8][N] with N =
    8 / 16 / 32 for a Cout that small, else slices of 64, Cin in whole chunks
    of 8; every (parity, tap, ci, co) at the address the kernel reads, zeros
    in the padding, the bias zero-padded to whole slices."""
    _, w, b = _case((1, 1, 1), cin, cout, seed=cin + cout + ksize)
    kw = kpack_conv.conv_kernel_weights(w, b, torch.float32, torch.device("cpu"), ksize)
    n = kpack_conv.f32_width(cout)
    assert n == next(v for v in (8, 16, 32, 64) if cout <= v or v == 64)
    slices, chunks = -(-cout // n), -(-cin // KC)
    assert (kw.route, kw.cin, kw.cout, kw.cin_pad, kw.cout_pad, kw.ksize) == (
        "f32", cin, cout, chunks * KC, slices * n, ksize)
    want = _per_tap(w, ksize)
    par, taps = want.shape[:2]
    flat = kw.wt.reshape(-1)
    assert flat.numel() == slices * chunks * par * taps * KC * n
    q, tap, ci, co = torch.meshgrid(torch.arange(par), torch.arange(taps), torch.arange(chunks * KC),
                                    torch.arange(slices * n), indexing="ij")
    addr = ((((co // n * chunks + ci // KC) * par + q) * taps + tap) * KC + ci % KC) * n + co % n
    got = flat[addr]
    assert torch.equal(got[:, :, :cin, :cout], want)
    assert not got[:, :, cin:].any() and not got[..., cout:].any()
    assert torch.equal(kw.bias[:cout], b) and not kw.bias[cout:].any()


# -- the kernel's work, emulated ---------------------------------------------------


def _thread_map(n, up):
    """Per thread of a block (4 N threads): channel group g, pixel group pg ->
    tile row, first window column c0, parity (pa, pb)."""
    cg = n // 8
    tid = torch.arange(4 * n)
    g, pg = tid % cg, tid // cg
    row = pg % 8 if up else pg // 2
    c0 = torch.zeros_like(pg) if up else (pg % 2) * 8
    q = pg // 8 if up else torch.zeros_like(pg)
    return g, row, c0, q // 2, q % 2


def emulated_conv(x, kw, act, *, x2=None, cin2=0, out=None, out_c0=0, residual=None, res_scale=1.0):
    """conv_f32_kernel's work, step by step, in f32, with the signature of
    ``kpack_conv.conv_f32_launch`` (what esr_conv_f32 hands the kernel)."""
    up = kw.ksize == 2
    gm = geo(up)
    n_img, h, w, lda = x.shape
    cin_a, cin_b = kw.cin - cin2, cin2
    cin = cin_a + cin_b
    n = kpack_conv.f32_width(kw.cout)
    slices, chunks = -(-kw.cout // n), -(-cin // KC)
    if out is None:
        out = torch.full((n_img, (2 if up else 1) * h, (2 if up else 1) * w, kw.cout), float("nan"))
    xa, xb = x.reshape(-1), (x2.reshape(-1) if x2 is not None else None)
    ldb = x2.shape[3] if x2 is not None else 0
    flat_out, out_ld = out.view(-1), out.shape[3]
    res, res_ld = (residual.reshape(-1), residual.shape[3]) if residual is not None else (None, 0)
    tiles_x, tiles_y = -(-w // gm["TW"]), -(-h // gm["TH"])
    kh, par, taps = gm["KH"], gm["PAR"], gm["KH"] ** 2
    wf = par * taps * KC * n
    wt = kw.wt.reshape(-1)
    g, row, c0, pa, pb = _thread_map(n, up)
    p8, j8 = torch.arange(8), torch.arange(8)
    ci_, ty_, tx_ = (t.reshape(-1) for t in torch.meshgrid(torch.arange(KC), torch.arange(kh), torch.arange(kh),
                                                            indexing="ij"))
    # per thread, pixel and (ci, ty, tx): the window float it reads; per
    # thread, channel and (ci, ty, tx): the weight float
    a_idx = (ci_ * gm["PS"] + (row[:, None, None] + pa[:, None, None] + ty_) * gm["WS"]
             + c0[:, None, None] + p8[None, :, None] + tx_ + pb[:, None, None])
    chan = (j8 // 4) * (n // 2) + j8 % 4
    assert int((p8[None, :, None] + tx_ + pb[:, None, None]).max()) < 10  # inside the 40 bytes read
    q = 2 * pa + pb
    b_idx = (q[:, None, None] * taps * KC * n + 4 * g[:, None, None] + ((ty_ * kh + tx_) * KC + ci_) * n
             + chan[None, :, None])
    for blk in range(n_img * tiles_x * tiles_y * slices):
        sl, t = blk % slices, blk // slices
        img, r = divmod(t, tiles_x * tiles_y)
        y0, x0 = (r // tiles_x) * gm["TH"], (r % tiles_x) * gm["TW"]
        acc = torch.zeros(4 * n, 8, 8)
        for c in range(chunks):
            win = torch.full((KC * gm["PS"],), float("nan"))  # cells the copy never writes stay NaN
            e = torch.arange(KC * gm["WR"] * gm["WC"])
            ch, p = e % KC, e // KC
            py, px = p // gm["WC"], p % gm["WC"]
            gy, gx, ci = y0 - 1 + py, x0 - 1 + px, c * KC + ch
            ok = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w) & (ci < cin)
            pix = (img * h + gy.clamp(0, h - 1)) * w + gx.clamp(0, w - 1)
            vals = torch.zeros(e.shape)
            from_a, from_b = ok & (ci < cin_a), ok & (ci >= cin_a)
            vals[from_a] = xa[(pix * lda + ci)[from_a]]
            if from_b.any():
                vals[from_b] = xb[(pix * ldb + ci - cin_a)[from_b]]
            win[ch * gm["PS"] + py * gm["WS"] + px] = vals
            wst = wt[(sl * chunks + c) * wf:(sl * chunks + c + 1) * wf]
            acc += torch.einsum("tpk,tjk->tpj", win[a_idx], wst[b_idx])
        bias = kw.bias[sl * n + 4 * g[:, None] + chan[None, :]] if kw.bias is not None else torch.zeros(4 * n, 8)
        v = acc + bias[:, None, :]
        if act:
            v = torch.where(v >= 0, v, 0.2 * v)
        for tid in range(4 * n):
            gy = y0 + int(row[tid])
            if gy >= h:
                continue
            for pp in range(8):
                gx = x0 + int(c0[tid]) + pp
                if gx >= w:
                    break
                a_, b_ = int(pa[tid]), int(pb[tid])
                opix = ((img * 2 * h + 2 * gy + a_) * 2 * w + 2 * gx + b_) if up else ((img * h + gy) * w + gx)
                co = sl * n + 4 * int(g[tid]) + chan
                keep = co < kw.cout
                vv = v[tid, pp][keep]
                if res is not None:
                    vv = res[opix * res_ld + co[keep]] + res_scale * vv
                flat_out[opix * out_ld + out_c0 + co[keep]] = vv
    return out


@pytest.mark.parametrize(
    "shape,cin,cout,ksize,act",
    [
        ((2, 19, 37), 64, 64, 3, False),
        ((1, 21, 9), 64, 64, 2, True),
        ((1, 16, 16), 4, 64, 3, True),
        ((2, 9, 11), 4, 64, 2, False),
        ((2, 19, 37), 64, 3, 3, False),
        ((1, 17, 20), 64, 3, 2, True),
        ((1, 5, 7), 3, 16, 3, True),
        ((1, 5, 7), 20, 32, 2, False),
        ((1, 18, 18), 24, 96, 3, True),
        ((1, 11, 9), 192, 256, 2, True),
        ((1, 9, 13), 256, 8, 3, False),
    ],
    ids=["3x3-64", "2x2-64", "3x3-cin4-b1-one-tile", "2x2-cin4", "3x3-cout3", "2x2-cout3",
         "3x3-smaller-than-a-tile", "2x2-smaller-than-a-tile-cout32", "3x3-two-slices-ragged",
         "2x2-cin192-four-slices", "3x3-cin256"],
)
def test_emulated_kernel_matches_plain(shape, cin, cout, ksize, act):
    """The kernel's walk in both modes, over ragged tiles, narrow and sliced
    Cout (every instance width), Cin with a zero-filled chunk tail and Cin
    192 / 256 (which the earlier f32 kernel could not hold in shared memory),
    equals the plain conv; every output element written exactly once where
    it belongs (the output starts as NaN)."""
    x, w, b = _case(shape, cin, cout, seed=sum(shape) + cin + cout + ksize)
    kw = kpack_conv.conv_kernel_weights(w, b, torch.float32, torch.device("cpu"), ksize)
    got = emulated_conv(x, kw, act)
    plain = kpack_conv.conv3x3_reference if ksize == 3 else upsample2x_conv3x3_reference
    want = plain(x, w, b, act)
    assert got.shape == want.shape and not torch.isnan(got).any()
    torch.testing.assert_close(got, want, atol=CONV_ATOL, rtol=0)


@pytest.mark.parametrize("c1,cin1,c2,cin2,cout,out_c0", [(16, 16, 24, 8, 8, 16), (12, 12, 24, 18, 6, 18),
                                                          (64, 64, 128, 96, 64, 0)])
def test_emulated_two_sources_offset_and_residual(c1, cin1, c2, cin2, cout, out_c0):
    """The RDB's use of the kernel: the input is the first cin1 channels of x
    then the first cin2 of x2 (a chunk may straddle them), the output goes to
    channels out_c0.. of a wider tensor (its other channels untouched), and
    out = residual + 0.2 * (conv + b) when a residual is given."""
    shape = (2, 13, 18)
    rng = np.random.default_rng(c1 + c2 + cout)
    x, x2 = _t(rng.standard_normal(shape + (c1,))), _t(rng.standard_normal(shape + (c2,)))
    w = _t(rng.standard_normal((3, 3, cin1 + cin2, cout)) * (2.0 / (9 * (cin1 + cin2))) ** 0.5)
    b = _t(0.1 * rng.standard_normal(cout))
    kw = kpack_conv.conv_kernel_weights(w, b, torch.float32, torch.device("cpu"), 3)
    cat = torch.cat([x[..., :cin1], x2[..., :cin2]], -1)
    want = kpack_conv.conv3x3_reference(cat, w, b, True)
    out = torch.full(shape + (out_c0 + cout + 3,), -7.0)
    got = emulated_conv(x, kw, True, x2=x2, cin2=cin2, out=out, out_c0=out_c0)
    assert got is out and (out[..., :out_c0] == -7).all() and (out[..., out_c0 + cout:] == -7).all()
    torch.testing.assert_close(out[..., out_c0:out_c0 + cout], want, atol=CONV_ATOL, rtol=0)
    res = _t(rng.standard_normal(shape + (cout,)))
    got = emulated_conv(x, kw, False, x2=x2, cin2=cin2, residual=res, res_scale=0.2)
    torch.testing.assert_close(got, res + 0.2 * kpack_conv.conv3x3_reference(cat, w, b, False), atol=CONV_ATOL,
                               rtol=0)


# -- the f32 RDB: five launches -----------------------------------------------------


def _rdb_params(nf, gc, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for k in range(1, 6):
        ci, co = nf + (k - 1) * gc, nf if k == 5 else gc
        p[f"w{k}"] = _t(rng.standard_normal((3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5)
        p[f"b{k}"] = _t(0.1 * rng.standard_normal(co))
    return p


@pytest.mark.parametrize("nf,gc,shape", [(16, 8, (2, 19, 23)), (12, 6, (1, 5, 7)), (8, 4, (1, 16, 17))],
                         ids=["nf16-gc8-ragged", "nf12-gc6-smaller-than-a-tile", "nf8-gc4"])
def test_f32_rdb_as_five_launches_matches_reference(nf, gc, shape):
    """rdb5c_kernel_weights in f32 holds the five convs' f32 layouts (no
    channel padding: nf and gc need not be multiples of 8); rdb5c_launch's
    composition (_rdb5c_f32), run on the emulated kernel, equals
    rdb5c_reference, with one RDB layout counted and no conv layout."""
    p = _rdb_params(nf, gc, seed=nf + gc)
    before = (rdb_conv.LAYOUTS.count, kpack_conv.LAYOUTS.count)
    kw = rdb_conv.rdb5c_kernel_weights(p, torch.float32, torch.device("cpu"))
    assert (rdb_conv.LAYOUTS.count - before[0], kpack_conv.LAYOUTS.count - before[1]) == (1, 0)
    assert isinstance(kw, rdb_conv.Rdb5cF32Weights) and (kw.nf, kw.gc, len(kw.convs)) == (nf, gc, 5)
    for k, conv in enumerate(kw.convs, start=1):
        assert (conv.route, conv.cin, conv.cout, conv.ksize) == ("f32", nf + (k - 1) * gc, nf if k == 5 else gc, 3)
        assert torch.equal(conv.bias[:conv.cout], p[f"b{k}"])
    x = _t(np.random.default_rng(1).standard_normal(shape + (nf,)))
    got = rdb_conv._rdb5c_f32(x, kw, emulated_conv)
    torch.testing.assert_close(got, rdb_conv.rdb5c_reference(x, p), atol=RDB_ATOL, rtol=0)


def test_f32_rdb_as_five_launches_matches_pallas_interpret():
    """The same composition on the flax block's own weights (nf 8, gc 4)
    against the Pallas kernel in interpret mode."""
    nf, gc = 8, 4
    block = ResidualDenseBlock5C(nf=nf, gc=gc, packed=False)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 13, 18, nf)), jnp.float32)
    kp = rdb5c_params_from_flax(block.init(jax.random.PRNGKey(3), x)["params"])
    ref = np.asarray(jax_fused_rdb5c(x, kp, interpret=True, strip=6))
    kw = rdb_conv.rdb5c_kernel_weights({k: _t(v) for k, v in kp.items()}, torch.float32, torch.device("cpu"))
    got = rdb_conv._rdb5c_f32(_t(x), kw, emulated_conv)
    np.testing.assert_allclose(got.numpy(), ref, atol=PALLAS_ATOL)
