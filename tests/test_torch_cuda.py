"""The port's CUDA kernels against their plain PyTorch versions, the eval
and serving entry points through them, and the train and Z steps, the eval
forward and KernelGAN's iteration as CUDA graphs against the same work
eagerly, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. They import neither JAX nor esr_tpu, so that they run where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

f32 tolerance 1e-4: up to 9 * 256 products summed in another order than
cuDNN's (TF32 off). bf16: within twice the bf16 plain version's own error
against the f32 plain version.
"""

import numpy as np
import pytest
import torch

from esr_tpu_torch.models.blocks import upsample_nearest
from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv
from esr_tpu_torch.ops.fused import upsample2x_conv3x3, upsample2x_conv3x3_reference

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")



def _rdb_params(nf, gc, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = {}
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        p[f"w{k}"] = (torch.randn(3, 3, cin, cout, generator=g) * (0.2 / cin**0.5)).to(device)
        p[f"b{k}"] = (0.1 * torch.randn(cout, generator=g)).to(device)
    return p


F32_TOL = 1e-4
ALL_COUNTERS = (rdb_conv.LAUNCHES, *rdb_conv.LAUNCHES_SIMT.values(), kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP,
                *kpack_conv.LAUNCHES_SIMT.values(), kpack_conv.LAUNCHES_F32)
# launches of conv_f32_kernel that one call of each f32 route makes
F32_KERNEL_LAUNCHES = {rdb_conv.LAUNCHES_SIMT["f32"]: 5, **{c: 1 for c in kpack_conv.LAUNCHES_SIMT.values()}}


def _counts():
    return [c.count for c in ALL_COUNTERS]


def _launched(before, counter):
    """Exactly one call since ``before``, on ``counter``, and the launches of
    conv_f32_kernel that its route makes (none for a bf16 route)."""
    want = [int(c is counter) for c in ALL_COUNTERS]
    want[-1] = F32_KERNEL_LAUNCHES.get(counter, 0)
    return [c.count - b for c, b in zip(ALL_COUNTERS, before)] == want


@pytest.mark.cuda
@pytest.mark.parametrize("strip,wtile", [(8, 8), (5, 7), (8, 12)])
def test_cuda_rdb5c_matches_plain(cuda, strip, wtile):
    """The f32 RDB (five f32 conv launches; the tile a hint) within F32_TOL of
    the plain version, one launch counted on the f32 RDB counter and none on
    any other, the conv counters included."""
    p = _rdb_params(64, 32, cuda)
    x = torch.randn(2, 19, 23, 64, device=cuda)
    before = _counts()
    with torch.no_grad():
        got = rdb_conv.fused_rdb5c_tiled(x, p, strip=strip, wtile=wtile)
    torch.cuda.synchronize()
    assert _launched(before, rdb_conv.LAUNCHES_SIMT["f32"])
    torch.testing.assert_close(got, rdb_conv.rdb5c_reference(x, p), atol=F32_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc,shape", [(64, 32, (2, 37, 53)), (64, 32, (1, 5, 7)), (16, 8, (2, 37, 53)),
                                         (16, 8, (1, 16, 40)), (12, 6, (1, 19, 21))])
def test_cuda_rdb5c_f32_widths_prepared(cuda, nf, gc, shape):
    """The f32 RDB through rdb5c_launch with its layouts built once, at the
    flagship's nf 64 / gc 32 and at nf 16 / gc 8 and nf 12 / gc 6 (widths
    that are not multiples of 8 need no padding), on ragged grids, batch 1
    and an image smaller than a tile, with and without a tile hint: within
    F32_TOL of the plain version, the same answer whatever the hint, one
    launch a block on the f32 RDB counter."""
    p = _rdb_params(nf, gc, cuda, seed=nf + sum(shape))
    x = torch.randn(*shape, nf, device=cuda, generator=torch.Generator(device=cuda).manual_seed(nf))
    kw = rdb_conv.rdb5c_kernel_weights(p, torch.float32, cuda)
    before = _counts()
    with torch.no_grad():
        got = rdb_conv.rdb5c_launch(x, kw)
    torch.cuda.synchronize()
    assert _launched(before, rdb_conv.LAUNCHES_SIMT["f32"])
    torch.testing.assert_close(got, rdb_conv.rdb5c_reference(x, p), atol=F32_TOL, rtol=0)
    with torch.no_grad():
        assert torch.equal(rdb_conv.rdb5c_launch(x, kw, strip=12, wtile=8), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,act", [(4, 64, False), (64, 64, True), (64, 3, False)])
def test_cuda_conv3x3_matches_plain(cuda, cin, cout, act):
    x = torch.randn(2, 21, 19, cin, device=cuda)
    w = torch.randn(3, 3, cin, cout, device=cuda) * 0.1
    b = torch.randn(cout, device=cuda)
    before = _counts()
    got = kpack_conv.kpack_conv3x3(x, w, b, act)
    assert _launched(before, kpack_conv.LAUNCHES_SIMT[(3, "f32")])
    ref = kpack_conv.conv3x3_reference(x, w, b, act)
    torch.testing.assert_close(got, ref, atol=F32_TOL, rtol=0)
    before = _counts()
    up = upsample2x_conv3x3(x, w, b, act)
    assert _launched(before, kpack_conv.LAUNCHES_SIMT[(2, "f32")])
    ref_up = kpack_conv.conv3x3_reference(upsample_nearest(x, 2), w, b, act)
    torch.testing.assert_close(up, ref_up, atol=F32_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 16, 40), (1, 5, 7)], ids=["ragged", "b1", "smaller-than-a-tile"])
@pytest.mark.parametrize("cout", [3, 8, 64, 256])
@pytest.mark.parametrize("cin", [3, 4, 64, 192, 256])
def test_cuda_conv_f32_any_width(cuda, shape, cin, cout):
    """conv_f32_kernel in both modes and both act values through conv_launch
    with its layout built once: Cin 3 and 4 (a zero-filled chunk tail) up to
    192 and 256 (which raised before: their whole window did not fit shared
    memory), Cout 3 and 8 (the narrow instance) up to 256 (four slices), on
    ragged grids, batch 1 and an image smaller than a tile: within F32_TOL of
    the f32 plain version, one launch counted on its mode's f32 counter and
    none on any other."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + cin + cout)
    x = torch.randn(*shape, cin, device=cuda, generator=g)
    w = torch.randn(3, 3, cin, cout, device=cuda, generator=g) * (2.0 / (9 * cin)) ** 0.5
    b = 0.1 * torch.randn(cout, device=cuda, generator=g)
    for ksize, plain in ((3, kpack_conv.conv3x3_reference), (2, upsample2x_conv3x3_reference)):
        kw = kpack_conv.conv_kernel_weights(w, b, torch.float32, cuda, ksize)
        for act in (False, True):
            before = _counts()
            with torch.no_grad():
                got = kpack_conv.conv_launch(x, kw, act)
            torch.cuda.synchronize()
            assert _launched(before, kpack_conv.LAUNCHES_SIMT[(ksize, "f32")]), (ksize, act)
            torch.testing.assert_close(got, plain(x, w, b, act), atol=F32_TOL, rtol=0)


@pytest.mark.cuda
def test_cuda_conv_f32_two_sources_offset_residual(cuda):
    """conv_f32_launch as the f32 RDB uses it: the first cin1 channels of x
    then the first cin2 of x2 (a chunk straddles them), written at a channel
    offset of a wider tensor (its other channels untouched), then with a
    residual: within F32_TOL of the plain conv of the concat."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x, x2 = torch.randn(2, 23, 29, 12, device=cuda, generator=g), torch.randn(2, 23, 29, 24, device=cuda, generator=g)
    w = torch.randn(3, 3, 30, 6, device=cuda, generator=g) * 0.1
    b = torch.randn(6, device=cuda, generator=g)
    kw = kpack_conv.conv_kernel_weights(w, b, torch.float32, cuda, 3)
    cat = torch.cat([x, x2[..., :18]], -1)
    out = torch.full((2, 23, 29, 24), -7.0, device=cuda)
    before = kpack_conv.LAUNCHES_F32.count
    with torch.no_grad():
        kpack_conv.conv_f32_launch(x, kw, True, x2=x2, cin2=18, out=out, out_c0=18)
        res = torch.randn(2, 23, 29, 6, device=cuda, generator=g)
        got = kpack_conv.conv_f32_launch(x, kw, False, x2=x2, cin2=18, residual=res, res_scale=0.2)
    assert kpack_conv.LAUNCHES_F32.count == before + 2
    assert (out[..., :18] == -7).all()
    torch.testing.assert_close(out[..., 18:], kpack_conv.conv3x3_reference(cat, w, b, True), atol=F32_TOL, rtol=0)
    torch.testing.assert_close(got, res + 0.2 * kpack_conv.conv3x3_reference(cat, w, b, False), atol=F32_TOL, rtol=0)


@pytest.mark.cuda
def test_cuda_rdb5c_bf16_any_tile_within_band(cuda):
    """The bf16 tensor-core kernel through both wrappers within twice the bf16
    plain version's error against the f32 plain version on the same bf16
    inputs; another tile is a hint: the tensor-core route runs it (one launch
    counted there) and gives the 16 x 16 answer bit for bit."""
    p = _rdb_params(64, 32, cuda)
    x = torch.randn(2, 21, 37, 64, device=cuda).bfloat16()
    ref = rdb_conv.rdb5c_reference(x.float(), p)
    plain_err = (rdb_conv.rdb5c_reference(x, p).float() - ref).abs().max().item()
    with torch.no_grad():
        for got in (rdb_conv.fused_rdb5c_tiled(x, p, strip=16, wtile=16), rdb_conv.fused_rdb5c(x, p)):
            err = (got.float() - ref).abs().max().item()
            assert err <= 2 * plain_err, (err, plain_err)
        before = rdb_conv.LAUNCHES.count
        other = rdb_conv.fused_rdb5c_tiled(x, p, strip=12, wtile=8)
        torch.cuda.synchronize()
        assert rdb_conv.LAUNCHES.count == before + 1
        assert torch.equal(other, rdb_conv.fused_rdb5c(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 16, 40), (1, 5, 7), (1, 33, 18), (3, 48, 32)],
                         ids=["ragged", "b1", "smaller-than-a-tile", "h-w-not-tile-multiples", "whole-tiles"])
def test_cuda_rdb5c_tc_prepared_within_band(cuda, shape):
    """rdb5c_tc_kernel through rdb5c_launch with its weight image built once
    (as the forward runs it) on ragged grids, batch 1 and images smaller than
    a tile: within the bf16 band of the f32 plain version on the same bf16
    inputs, one counted launch each, deterministic from call to call."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    p = _rdb_params(64, 32, cuda, seed=sum(shape))
    x = torch.randn(*shape, 64, device=cuda, generator=g).bfloat16()
    kw = rdb_conv.rdb5c_kernel_weights(p, torch.bfloat16, cuda)
    before = rdb_conv.LAUNCHES.count
    with torch.no_grad():
        got = rdb_conv.rdb5c_launch(x, kw)
        again = rdb_conv.rdb5c_launch(x, kw)
    torch.cuda.synchronize()
    assert rdb_conv.LAUNCHES.count == before + 2
    ref = rdb_conv.rdb5c_reference(x.float(), p)
    plain_err = (rdb_conv.rdb5c_reference(x, p).float() - ref).abs().max().item()
    err = (got.float() - ref).abs().max().item()
    assert err <= 2 * plain_err, (err, plain_err)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_flagship_forward_counts_launches(cuda):
    """The eval forward on CUDA launches 3 RDB kernels per RRDB and the conv
    kernels, and stays consistent with its LR input."""
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.models import define_G, make_eval_forward

    opt = {"network_G": {"nf": 64, "nb": 2, "gc": 32, "num_latent_channels": 1}, "scale": 4}
    g = define_G(opt, device=cuda)
    cem = make_cem(CEMConf(scale=4), device=cuda)
    counters = (rdb_conv.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP)
    for c in counters:
        c.reset()
    lr = torch.rand(1, 24, 20, 3, device=cuda)
    out = make_eval_forward(g, cem)(lr)
    assert [c.count for c in counters] == [6, 4, 2]
    assert (cem.downsample(out) - lr).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,act", [(4, 64, False), (64, 64, True), (64, 3, False)])
def test_cuda_conv3x3_bf16_within_band(cuda, cin, cout, act):
    """bf16 tensor-core conv (3x3 and 2x2 parity modes) vs the f32 plain
    version on the same bf16 inputs: within twice the bf16 plain version's
    own error, or two bf16 ulps (2^-6 relative) of the largest output."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 21, 19, cin, device=cuda, generator=g).bfloat16()
    w = torch.randn(3, 3, cin, cout, device=cuda, generator=g) * (2.0 / (9 * cin)) ** 0.5
    b = 0.1 * torch.randn(cout, device=cuda, generator=g)
    cases = (
        (kpack_conv.kpack_conv3x3, kpack_conv.conv3x3_reference),
        (upsample2x_conv3x3, upsample2x_conv3x3_reference),
    )
    for fn, plain in cases:
        ref = plain(x.float(), w, b, act)
        plain_err = (plain(x, w, b, act).float() - ref).abs().max().item()
        tol = max(2 * plain_err, 2.0**-6 * ref.abs().max().item())
        err = (fn(x, w, b, act).float() - ref).abs().max().item()
        assert err <= tol, (fn.__name__, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_prepared_kernel_weights_match_per_call(cuda, dtype):
    """The generator with its kernel weight layout built once
    (prepare_kernels) computes exactly what it computes building it per call."""
    from esr_tpu_torch.models import define_G

    opt = {"network_G": {"nf": 64, "nb": 1, "gc": 32, "num_latent_channels": 1}, "scale": 4,
           "bf16": dtype == torch.bfloat16}
    g = define_G(opt, device=cuda)
    lr = torch.rand(2, 13, 17, 3, device=cuda)
    with torch.no_grad():
        per_call = g(lr)
        g.prepare_kernels()
        assert g.RRDB_trunk[0].RDB1.kernel_weights is not None
        prepared = g(lr)
    torch.testing.assert_close(prepared, per_call, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 16, 16), (1, 5, 40)], ids=["ragged", "b1-one-tile", "b1-thin"])
@pytest.mark.parametrize("cin,cout", [(4, 64), (64, 64), (64, 3), (16, 32)])
@pytest.mark.parametrize("act", [False, True])
def test_cuda_conv_tc_prepared_within_band(cuda, shape, cin, cout, act):
    """The bf16 tensor-core kernel in both modes through conv_launch with its
    weight image built once (as the forward runs it), on ragged grids and
    batch 1, conv_first's Cin 4 (plain window loads), conv_last's Cout 3
    (pixels as M, wgmma n8, 2-byte stores) and a Cout of 32 (written as 64
    channels and sliced): within the bf16 band of the f32 plain version on
    the same bf16 inputs, one counted launch each."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + cin + cout)
    x = torch.randn(*shape, cin, device=cuda, generator=g).bfloat16()
    w = torch.randn(3, 3, cin, cout, device=cuda, generator=g) * (2.0 / (9 * cin)) ** 0.5
    b = 0.1 * torch.randn(cout, device=cuda, generator=g)
    for ksize, counter, plain in (
        (3, kpack_conv.LAUNCHES, kpack_conv.conv3x3_reference),
        (2, kpack_conv.LAUNCHES_UP, upsample2x_conv3x3_reference),
    ):
        kw = kpack_conv.conv_kernel_weights(w, b, torch.bfloat16, cuda, ksize)
        before = counter.count
        with torch.no_grad():
            got = kpack_conv.conv_launch(x, kw, act)
        torch.cuda.synchronize()
        assert counter.count == before + 1
        ref = plain(x.float(), w, b, act)
        assert got.shape == ref.shape
        plain_err = (plain(x, w, b, act).float() - ref).abs().max().item()
        tol = max(2 * plain_err, 2.0**-6 * ref.abs().max().item())
        err = (got.float() - ref).abs().max().item()
        assert err <= tol, (ksize, err, tol)


_COUNTERS = (rdb_conv.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP)


def _nb2_options(root, **extra):
    """The flagship widths (nf 64, gc 32: the bf16 kernels' widths), nb 2, one
    Z channel, CEM, bf16 kernels, seeded weights."""
    opt = {"name": "cuda_eval", "model": "srragan", "scale": 4, "use_cem": True, "bf16": True,
           "num_random_Z": 1, "watchdog": False, "path": {"root": str(root)},
           "datasets": {"test_1": {"name": "syn", "mode": "SYNTHETIC", "n_images": 2, "image_size": 64}},
           "network_G": {"nf": 64, "nb": 2, "gc": 32, "num_latent_channels": 1}}
    opt.update(extra)
    return opt


@pytest.mark.cuda
@pytest.mark.parametrize("eval_batch", [0, 2])
def test_cuda_eval_counts_launches_and_keeps_cem(cuda, tmp_path, eval_batch):
    """evaluate_dataset on the card, serial and batched: 2 images x 2 Z draws
    launch 6 rdb5c, 4 conv3x3 and 2 upsample kernels per forward, and every
    draw is CEM-consistent to 1e-5."""
    from esr_tpu_torch import test as eval_cli
    from esr_tpu_torch.data import create_dataloader, create_dataset
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    opt = parse(_nb2_options(tmp_path, eval_batch=eval_batch), is_train=False)
    model = create_model(opt)
    d = opt["datasets"]["test_1"]
    for c in _COUNTERS:
        c.reset()
    res = eval_cli.evaluate_dataset(model, create_dataloader(create_dataset(d), d), opt)
    torch.cuda.synchronize()
    forwards = 4 if eval_batch == 0 else 2
    assert [c.count for c in _COUNTERS] == [6 * forwards, 4 * forwards, 2 * forwards]
    assert res["cem_residual"] <= 1e-5 and np.isfinite(res["psnr"]) and res["z_diversity"] > 0


@pytest.mark.cuda
def test_cuda_servable_round_trip(cuda, tmp_path):
    """export_servable -> load_servable on the card: one forward per sr()
    call, equal to the live forward on the edge-padded LR and Z, cropped
    back, CEM-consistent to 1e-5 w.r.t. the padded LR."""
    from esr_tpu_torch.export import export_servable, load_servable
    from esr_tpu_torch.models import create_model, make_eval_forward
    from esr_tpu_torch.options import parse

    model = create_model(parse(_nb2_options(tmp_path), is_train=False))
    export_servable(model, [(1, 32, 32)], str(tmp_path / "art"))
    sv = load_servable(str(tmp_path / "art"))
    rng = np.random.default_rng(0)
    lr = rng.random((1, 24, 19, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (1, 24, 19, 1)).astype(np.float32)
    for c in _COUNTERS:
        c.reset()
    got = sv.sr(lr, z)
    torch.cuda.synchronize()
    assert [c.count for c in _COUNTERS] == [6, 4, 2]
    pad = ((0, 0), (0, 8), (0, 13), (0, 0))
    lr_p = torch.from_numpy(np.pad(lr, pad, mode="edge")).to(cuda)
    out = make_eval_forward(model.g_module, model.cem)(lr_p, torch.from_numpy(np.pad(z, pad, mode="edge")).to(cuda))
    np.testing.assert_array_equal(got, out[:, :96, :76].cpu().numpy())
    assert (model.cem.downsample(out) - lr_p).abs().max().item() <= 1e-5


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["rdb5c", "conv3x3", "upsample2x"])
def test_cuda_autograd_functions_match_plain_autograd(cuda, which):
    """Each kernel's autograd Function on the card: the forward is the
    kernel's (one launch, none in the backward), the gradients of x and of
    the parameters those of plain autograd through the plain version in bf16
    (the Function's backward recomputes it: the same ops, 1e-3 relative L2
    for cuDNN's choice of algorithms)."""
    from esr_tpu_torch.ops.cuda import autograd as fns

    torch.backends.cudnn.deterministic = True
    try:
        if which == "rdb5c":
            params = {k: v.requires_grad_(True) for k, v in _rdb_params(64, 32, cuda).items()}
            x = torch.randn(2, 19, 23, 64, device=cuda).bfloat16().requires_grad_(True)
            counter, leaves = rdb_conv.LAUNCHES, [x, *params.values()]
            fn, plain = (lambda: fns.rdb5c_fn(x, params)), (lambda: rdb_conv.rdb5c_reference(x, params))
        else:
            x = torch.randn(2, 21, 19, 64, device=cuda).bfloat16().requires_grad_(True)
            w = (torch.randn(3, 3, 64, 64, device=cuda) * 0.05).requires_grad_(True)
            b = (torch.randn(64, device=cuda) * 0.1).requires_grad_(True)
            leaves = [x, w, b]
            if which == "conv3x3":
                counter = kpack_conv.LAUNCHES
                fn, plain = (lambda: fns.conv3x3_fn(x, w, b, True)), (lambda: kpack_conv.conv3x3_reference(x, w, b, True))
            else:
                counter = kpack_conv.LAUNCHES_UP
                fn = lambda: fns.upsample2x_conv3x3_fn(x, w, b, True)  # noqa: E731
                plain = lambda: upsample2x_conv3x3_reference(x, w, b, True)  # noqa: E731
        before = counter.count
        y = fn()
        gy = torch.randn_like(y)
        grads = torch.autograd.grad(y, leaves, gy)
        torch.cuda.synchronize()
        assert counter.count == before + 1
        y_ref = plain()
        want = torch.autograd.grad(y_ref, leaves, gy)
        assert _rel_l2(y, y_ref) <= 2e-2  # kernel vs plain forward, both bf16
        for g, r in zip(grads, want):
            assert g.dtype == r.dtype and _rel_l2(g, r) <= 1e-3
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_cuda_gan_train_step_counts_launches(cuda, tmp_path):
    """One GAN train step of a full-width nb-1 model on the card: the G
    forward launches 3 rdb5c, 4 conv3x3 and 2 upsample kernels, the backward
    none; losses finite; G and D move."""
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    opt = _nb2_options(tmp_path, name="cuda_train")
    opt["network_G"]["nb"] = 1
    opt["datasets"] = {"train": {"name": "syn", "mode": "SYNTHETIC", "batch_size": 2, "HR_size": 64}}
    opt["network_D"] = {"nf": 16}
    opt["train"] = {"pixel_weight": 0.01, "feature_weight": 1.0, "gan_weight": 0.005, "range_weight": 1.0,
                    "map_weight": 1.0}
    model = create_model(parse(opt, is_train=True))
    g0 = model.g_module.conv_first.weight.detach().clone()
    model.feed_data({"HR": (np.random.default_rng(0).random((2, 64, 64, 3)) * 255).astype(np.uint8)})
    for c in _COUNTERS:
        c.reset()
    model.optimize_parameters(1)
    losses = model.get_current_losses()
    torch.cuda.synchronize()
    assert [c.count for c in _COUNTERS] == [3, 4, 2]
    assert all(np.isfinite(v) for v in losses.values())
    assert not torch.equal(g0, model.g_module.conv_first.weight)


@pytest.mark.cuda
def test_cuda_load_network_rebuilds_the_layouts(cuda, tmp_path):
    """An eval model built on weights A, then loaded with weights B, answers
    bit for bit as a fresh model built on B (the kernels' layouts of A are
    dropped and rebuilt)."""
    from esr_tpu_torch.models import create_model, define_G
    from esr_tpu_torch.options import parse

    opt = _nb2_options(tmp_path, name="cuda_load")
    path_a, path_b = str(tmp_path / "A.pth"), str(tmp_path / "B.pth")
    for seed, path in ((1, path_a), (2, path_b)):
        torch.save(define_G(opt, device=cuda, seed=seed).state_dict(), path)
    rng = np.random.default_rng(0)
    data = {"LR": rng.random((20, 24, 3)).astype(np.float32)}
    z = rng.uniform(-1, 1, (20, 24, 1)).astype(np.float32)

    def answer(model):
        model.feed_data(data)
        model.test(z)
        return model.get_visuals_device()["SR"].clone()

    reloaded = create_model(parse(dict(opt, path=dict(opt["path"], pretrain_model_G=path_a)), is_train=False))
    on_a = answer(reloaded)
    reloaded.load_network(path_b)
    fresh = create_model(parse(dict(opt, path=dict(opt["path"], pretrain_model_G=path_b)), is_train=False))
    got, want = answer(reloaded), answer(fresh)
    assert not torch.equal(on_a, want)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc,shape", [(8, 4, (2, 37, 53)), (16, 8, (1, 45, 30)), (12, 6, (1, 17, 9)),
                                         (48, 24, (2, 37, 53)), (128, 64, (1, 45, 30))])
def test_cuda_rdb5c_bf16_other_widths_within_band(cuda, nf, gc, shape):
    """bf16 RDBs at widths other than the flagship's run the tensor-core
    kernel, zero-padded to its narrowest instance that holds them (32 / 16,
    64 / 32 or 128 / 64), one launch counted on its counter and none on any
    other, at the default tile and at another (a hint), within twice the
    bf16 plain version's error against the f32 plain version on the same
    bf16 inputs."""
    p = _rdb_params(nf, gc, cuda, seed=nf)
    x = torch.randn(*shape, nf, device=cuda, generator=torch.Generator(device=cuda).manual_seed(nf)).bfloat16()
    ref = rdb_conv.rdb5c_reference(x.float(), p)
    tol = 2 * (rdb_conv.rdb5c_reference(x, p).float() - ref).abs().max().item()
    before = _counts()
    with torch.no_grad():
        outs = [rdb_conv.fused_rdb5c(x, p), rdb_conv.fused_rdb5c_tiled(x, p, strip=8, wtile=12)]
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(ALL_COUNTERS, before)] == [2 * int(c is rdb_conv.LAUNCHES) for c in ALL_COUNTERS]
    for got in outs:
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        assert (got.float() - ref).abs().max().item() <= tol
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_cuda_rdb5c_bf16_past_the_limit_raises(cuda):
    """A bf16 RDB wider than the widest instance (nf 128, gc 64) raises
    ValueError on the card, naming the limit, and launches nothing."""
    before = _counts()
    for nf, gc in ((136, 32), (64, 72)):
        p = _rdb_params(nf, gc, cuda)
        x = torch.zeros(1, 8, 8, nf, device=cuda, dtype=torch.bfloat16)
        with torch.no_grad(), pytest.raises(ValueError, match="nf up to 128 and gc up to 64"):
            rdb_conv.fused_rdb5c(x, p)
    assert _counts() == before


def _wide_conv_case(cuda, shape, cin, cout):
    g = torch.Generator(device=cuda).manual_seed(cin + cout)
    x = torch.randn(*shape, cin, device=cuda, generator=g).bfloat16()
    w = torch.randn(3, 3, cin, cout, device=cuda, generator=g) * (2.0 / (9 * cin)) ** 0.5
    b = 0.1 * torch.randn(cout, device=cuda, generator=g)
    return x, w, b


def _conv_band(plain, x, w, b):
    """The bf16 conv band against the f32 plain version on the same bf16 inputs."""
    ref = plain(x.float(), w, b, True)
    tol = max(2 * (plain(x, w, b, True).float() - ref).abs().max().item(), 2.0**-6 * ref.abs().max().item())
    return ref, tol


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(128, 128), (64, 96), (128, 3)])
def test_cuda_conv_bf16_wide_on_tensor_cores_within_band(cuda, cin, cout):
    """bf16 convs wider than 64 channels (Cin in K chunks, Cout in slices of
    64) run the tensor-core kernel in both modes, one launch counted on its
    mode's counter and none on the other, the f32 routes or the f32 kernel,
    within the bf16 conv band."""
    x, w, b = _wide_conv_case(cuda, (2, 21, 19), cin, cout)
    counters = (kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP, *kpack_conv.LAUNCHES_SIMT.values(),
                kpack_conv.LAUNCHES_F32)
    for i, (fn, plain) in enumerate(((kpack_conv.kpack_conv3x3, kpack_conv.conv3x3_reference),
                                     (upsample2x_conv3x3, upsample2x_conv3x3_reference))):
        before = [c.count for c in counters]
        with torch.no_grad():
            got = fn(x, w, b, True)
        torch.cuda.synchronize()
        assert [c.count - n for c, n in zip(counters, before)] == [int(i == j) for j in range(len(counters))]
        ref, tol = _conv_band(plain, x, w, b)
        assert got.shape == ref.shape and (got.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_conv_bf16_64_to_576_within_band(cuda):
    """SRResNet x3's upconv width, 64 -> 576 (nine Cout slices), on a ragged
    batch-2 grid: one tensor-core launch, within the bf16 conv band."""
    x, w, b = _wide_conv_case(cuda, (2, 37, 53), 64, 576)
    before = kpack_conv.LAUNCHES.count
    with torch.no_grad():
        got = kpack_conv.kpack_conv3x3(x, w, b, True)
    torch.cuda.synchronize()
    assert kpack_conv.LAUNCHES.count == before + 1
    ref, tol = _conv_band(kpack_conv.conv3x3_reference, x, w, b)
    assert got.shape == ref.shape and (got.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_conv_bf16_past_the_limit_raises(cuda):
    """A bf16 conv wider than the tensor-core kernel takes raises ValueError
    on the card too; no other route runs it."""
    x, w, b = _wide_conv_case(cuda, (1, 8, 8), 192, 64)
    with torch.no_grad(), pytest.raises(ValueError, match="Cin up to 128"):
        kpack_conv.kpack_conv3x3(x, w, b, True)


@pytest.mark.cuda
def test_cuda_bf16_small_model_runs_on_the_kernels(cuda):
    """A bf16 generator at nf 8, gc 4 (the widths of `__graft_entry__.py`'s dryrun) runs on the
    card: RDBs on the tensor-core RDB kernel (its 32 / 16 instance), convs
    on the tensor-core conv kernel, and its answer is finite."""
    from esr_tpu_torch.models import define_G, make_eval_forward

    opt = {"network_G": {"nf": 8, "nb": 2, "gc": 4, "num_latent_channels": 1}, "scale": 4, "bf16": True}
    g = define_G(opt, device=cuda, seed=3)
    lr = torch.rand(1, 20, 24, 3, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    before = (rdb_conv.LAUNCHES.count, kpack_conv.LAUNCHES.count)
    out = make_eval_forward(g)(lr)
    torch.cuda.synchronize()
    assert (rdb_conv.LAUNCHES.count - before[0], kpack_conv.LAUNCHES.count - before[1]) == (6, 4)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_cuda_frozen_z_step_builds_no_layout(cuda):
    """A Z step through a frozen generator (requires_grad off, layouts from
    prepare_kernels): the forward launches every kernel once per block on the
    prebuilt layouts (no layout built), the backward launches none, and dz
    is what the per-call layouts give."""
    from esr_tpu_torch.models import define_G

    opt = {"network_G": {"nf": 64, "nb": 1, "gc": 32, "num_latent_channels": 1}, "scale": 4, "bf16": True}
    g = define_G(opt, device=cuda, seed=4).requires_grad_(False)
    g.prepare_kernels()
    lr = torch.rand(1, 16, 20, 3, device=cuda)
    z = torch.zeros(1, 16, 20, 1, device=cuda, requires_grad=True)
    layouts = (rdb_conv.LAYOUTS, kpack_conv.LAYOUTS)
    builds = [c.count for c in layouts]
    for c in _COUNTERS:
        c.reset()
    out = g(lr, z)
    fwd = [c.count for c in _COUNTERS]
    (dz,) = torch.autograd.grad(out.square().mean(), z)
    torch.cuda.synchronize()
    assert fwd == [3, 4, 2] and [c.count for c in _COUNTERS] == fwd
    assert [c.count for c in layouts] == builds
    g.release_kernels()
    z2 = z.detach().clone().requires_grad_(True)
    (dz_per_call,) = torch.autograd.grad(g(lr, z2).square().mean(), z2)
    assert [c.count for c in layouts] != builds  # without the layouts, each call builds its own
    assert _rel_l2(dz, dz_per_call) <= 1e-3  # the same kernels; cuDNN's recompute may pick other algorithms


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fft", "filter"])
@pytest.mark.parametrize("kernel", ["aniso_gauss", "bicubic_2d"])
def test_cuda_cem_nonseparable_modes_with_tf32_default(cuda, kernel, mode):
    """CEM's fft and filter modes under a 2-D kernel on the card with cuDNN's
    TF32 at torch's default (on): H equals the f64 CPU H to 1e-5 (TF32 is off
    inside CEM's convs) and the projection is consistent (fft 1e-5; filter
    at support 33, 2e-3)."""
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.cem.kernels import downsample_kernel_2d
    from esr_tpu_torch.scripts.blind_bench import gaussian_kernel

    k = gaussian_kernel() if kernel == "aniso_gauss" else downsample_kernel_2d(4)[0]
    conf = CEMConf(scale=4, kernel=tuple(map(tuple, k)), inv_mode=mode, inv_filter_support=33)
    g = torch.Generator(device=cuda).manual_seed(11)
    raw = torch.rand(2, 160, 192, 3, device=cuda, generator=g) * 3 - 1
    lr = torch.rand(2, 40, 48, 3, device=cuda, generator=g)
    torch.backends.cudnn.allow_tf32 = True
    try:
        cem = make_cem(conf, device=cuda)
        with torch.no_grad():
            res = (cem.downsample(cem.project(raw, lr)) - lr).abs().max().item()
            h = cem.downsample(raw).double().cpu()
        assert torch.backends.cudnn.allow_tf32  # CEM restores the caller's setting
    finally:
        torch.backends.cudnn.allow_tf32 = False
    h64 = make_cem(conf, device="cpu").downsample(raw.double().cpu())
    assert cem._mode == mode and (h - h64).abs().max().item() <= 1e-5
    assert res <= (1e-5 if mode == "fft" else 2e-3), res


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sr_resnet", "all_layers"])
def test_cuda_generator_variants_on_the_kernels(cuda, which):
    """SRResNet (nf 64, nb 2, x4) and the all_layers RRDBNet (nf 64, nb 2,
    gc 32) in bf16 on the card: every 3x3 conv and RDB on its tensor-core
    kernel (SRResNet's 64 -> 256 upconvs too), and the answer within twice
    the bf16 plain path's relative L2 from the f32 plain path (the same
    weights on the CPU)."""
    from esr_tpu_torch.models import define_G

    net = {"nf": 64, "nb": 2, "num_latent_channels": 1}
    net.update({"which_model_G": "sr_resnet"} if which == "sr_resnet" else {"gc": 32, "latent_input": "all_layers"})
    opt = {"network_G": net, "scale": 4, "bf16": True}
    g = define_G(opt, device=cuda, seed=5)
    g.prepare_kernels()
    gen = torch.Generator().manual_seed(5)
    lr = torch.rand(1, 16, 20, 3, generator=gen)
    z = torch.rand(1, 16, 20, 1, generator=gen) * 2 - 1
    for c in _COUNTERS:
        c.reset()
    with torch.no_grad():
        got = g(lr.to(cuda), z.to(cuda)).cpu()
        torch.cuda.synchronize()
        counts = [c.count for c in _COUNTERS]
        plain = {bf16: define_G(dict(opt, bf16=bf16), device="cpu", seed=5)(lr, z) for bf16 in (True, False)}
    assert counts == ([0, 10, 0] if which == "sr_resnet" else [6, 4, 2]), counts
    assert _rel_l2(got, plain[False]) <= 2 * _rel_l2(plain[True], plain[False])


@pytest.mark.cuda
def test_cuda_kernelgan_effective_kernel_is_exact(cuda):
    """KernelGAN's linear G on the card, cuDNN's TF32 at torch's default:
    its stride-1 output is one VALID correlation with its effective kernel
    to 1e-5, and the strided output its ::4 subsample bit for bit."""
    import torch.nn.functional as F

    from esr_tpu_torch.cem import kernelgan as kg

    conf = kg.KernelGANConf()
    g = kg.LinearKernelG(conf, seed=3).to(cuda)
    x = torch.rand(1, 96, 96, 1, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            k = kg.effective_kernel(g, conf)
            flat = g(x, stride=False)
            strided = g(x)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        want = F.conv2d(x.permute(0, 3, 1, 2), k[None, None]).permute(0, 2, 3, 1)
    assert tuple(k.shape) == (21, 21) and (flat - want).abs().max().item() <= 1e-5
    assert torch.equal(strided, flat[:, ::4, ::4])


@pytest.fixture(scope="module")
def parallel_axes(tmp_path_factory):
    """2 ranks of a gloo group on the one card (tests/torch_parallel_workers.py):
    the sharded eval forwards of a bf16 net at the flagship widths, nb 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import torch_parallel_workers as W

    from esr_tpu_torch.models.architecture import RRDBNet
    from esr_tpu_torch.parallel import comm

    cfg = dict(nf=64, nb=2, gc=32, scale=4, num_latent_channels=1)
    state = {k: v.numpy() for k, v in RRDBNet(**cfg, seed=1).state_dict().items()}
    rng = np.random.default_rng(3)
    p = {"cfg": cfg, "state": state, "halo": 4, "lr": rng.random((2, 32, 24, 3), dtype=np.float32),
         "z": rng.uniform(-1, 1, (2, 32, 24, 1)).astype(np.float32)}
    g = RRDBNet(**cfg, dtype=torch.bfloat16, seed=1).cuda()
    g.prepare_kernels()
    with torch.no_grad():
        whole = g(torch.from_numpy(p["lr"]).cuda(), torch.from_numpy(p["z"]).cuda()).float().cpu().numpy()
    ranks = comm.spawn(W.cuda_axes_2, 2, tmp_path_factory.mktemp("cuda_ranks"), args=(p,), timeout=300)
    return ranks, whole


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["spatial", "tp", "pp"])
def test_cuda_parallel_axes_on_the_kernels(parallel_axes, axis):
    """eval_spatial (halo 4 on LR 32: each rank's G runs on a window of 24
    of the 32 rows; the rows at least a halo from the seam equal the
    whole-image kernel forward's bit for bit, every row within bf16 rounding
    of it), eval_tp (within bf16 rounding of it: each partial conv rounds its
    output) and eval_pp (bit for bit: the kernels' per-pixel sums do not
    depend on the batch) over 2 ranks on the one card, each rank launching
    its kernels: 6 / 4 / 2, 0 / 4 + 30 / 2 and 3 a microbatch / 4 / 2
    (rdb5c / conv3x3 / upsample)."""
    ranks, whole = parallel_axes
    want = {"spatial": {"rdb5c": 6, "conv3x3": 4, "upsample2x_conv3x3": 2},
            "tp": {"rdb5c": 0, "conv3x3": 34, "upsample2x_conv3x3": 2},
            "pp": {"rdb5c": 6, "conv3x3": 4, "upsample2x_conv3x3": 2}}[axis]
    seam, halo = 16 * 4, 4 * 4  # HR rows
    for r in ranks:
        out = r[axis]["out"]
        assert r[axis]["counts"] == want, r[axis]["counts"]
        if axis == "spatial":
            assert r[axis]["rows"] == [24], r[axis]["rows"]
            far = np.r_[0 : seam - halo, seam + halo : out.shape[1]]
            np.testing.assert_array_equal(out[:, far], whole[:, far])
        if axis == "pp":
            np.testing.assert_array_equal(out, whole)
        else:
            assert np.abs(out - whole).max() <= 2.0**-6 * np.abs(whole).max(), np.abs(out - whole).max()


@pytest.mark.cuda
def test_cuda_old_layout_checkpoint_loads_on_the_card(cuda, tmp_path):
    """A generator file in the reference's old key layout (``model.N``, the
    RDB convs' ``.0``) loads strictly through ``load_network`` onto the card
    and gives, through the bf16 kernels, the same SR bit for bit as the file
    with the port's keys."""
    import re

    from esr_tpu_torch.models import create_model, define_G
    from esr_tpu_torch.options import parse

    net = {"which_model_G": "RRDB_net", "nf": 64, "nb": 2, "gc": 32, "num_latent_channels": 1}
    state = define_G({"network_G": net, "scale": 4}, device="cpu", seed=4).state_dict()
    names = {"conv_first": "model.0", "trunk_conv": "model.1.sub.2", "upconv1": "model.3", "upconv2": "model.6",
             "HRconv": "model.8", "conv_last": "model.10"}
    old = {}
    for k, v in state.items():
        base, leaf = k.rsplit(".", 1)
        m = re.match(r"RRDB_trunk\.(\d+)\.(.+)$", base)
        old[(f"model.1.sub.{m[1]}.{m[2]}.0" if m else names[base]) + "." + leaf] = v
    srs = []
    for name, st in (("new", state), ("old", old)):
        pth = str(tmp_path / f"{name}.pth")
        torch.save(st, pth)
        opt = parse({"model": "sr", "scale": 4, "use_cem": True, "bf16": True, "network_G": net,
                     "path": {"pretrain_model_G": pth}}, is_train=False)
        model = create_model(opt, device=cuda)
        model.feed_data({"LR": np.random.default_rng(0).random((24, 20, 3), dtype=np.float32)})
        before = rdb_conv.LAUNCHES.count
        model.test()
        srs.append(model.get_current_visuals()["SR"])
        assert rdb_conv.LAUNCHES.count - before == 6
    np.testing.assert_array_equal(srs[0], srs[1])


@pytest.mark.cuda
def test_cuda_graft_entry_runs_the_flagship_on_the_kernels(cuda):
    """``graft_entry.entry()``'s forward on its example arguments: 69 / 4 / 2
    launches (rdb5c / conv3x3 / upsample), a CEM residual of at most 1e-5,
    finite SR of B2 x 256 x 256."""
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.graft_entry import entry

    fn, (lr, z) = entry()
    counters = (rdb_conv.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP)
    before = [c.count for c in counters]
    out = fn(lr, z)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [69, 4, 2]
    assert tuple(out.shape) == (2, 256, 256, 3) and bool(torch.isfinite(out).all())
    assert (make_cem(CEMConf(scale=4), device=cuda).downsample(out) - lr).abs().max().item() <= 1e-5


def _graph_train_options(root):
    opt = _nb2_options(root, name="cuda_graph_train")
    opt["network_G"]["nb"] = 1
    opt["datasets"] = {"train": {"name": "syn", "mode": "SYNTHETIC", "batch_size": 2, "HR_size": 64}}
    opt["network_D"] = {"nf": 16}
    opt["train"] = {"pixel_weight": 0.01, "feature_weight": 1.0, "gan_weight": 0.005, "range_weight": 1.0,
                    "map_weight": 1.0, "lr_steps": [2]}
    return opt


@pytest.mark.cuda
def test_cuda_gan_step_graph_equals_eager(cuda, tmp_path):
    """Three GAN steps (across an lr_steps milestone) replayed as the step's
    CUDA graph against the same steps eagerly, from the same seeds, with
    cuDNN's deterministic algorithms: weights, Adam moments and metrics bit
    for bit, and each step's launches (3 / 4 / 2) counted on replays too."""
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    rng = np.random.default_rng(0)
    batches = [{"HR": (rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)} for _ in range(3)]
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for graphed in (True, False):
            model = create_model(parse(_graph_train_options(tmp_path), is_train=True))
            model._step_graphs.enabled = graphed
            losses, counts = [], []
            for i, b in enumerate(batches):
                before = [c.count for c in _COUNTERS]
                model.feed_data(b)
                model.optimize_parameters(i + 1)
                losses.append(model.get_current_losses())
                counts.append([c.count - n for c, n in zip(_COUNTERS, before)])
            torch.cuda.synchronize()
            runs.append((model, losses, counts))
        (mg, lg, cg), (me, le, ce) = runs
        assert len(mg._step_graphs.steps) == 1 and mg._step_graphs.steps[0].graph is not None
        assert cg == ce == [[3, 4, 2]] * 3
        assert lg == le
        for a, b in ((mg.g_module, me.g_module), (mg.d_module, me.d_module)):
            assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
        for a, b in ((mg.g_opt, me.g_opt), (mg.d_opt, me.d_opt)):
            assert a.count == b.count == 3
            assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_cuda_z_search_graph_equals_eager(cuda):
    """A 6-step Z search through a frozen nb-1 flagship-width generator
    (prebuilt layouts, CEM) replayed as a CUDA graph against the same search
    eagerly: trace, Z and best Z bit for bit, 3 / 4 / 2 launches a step, and
    a second search on the same buffers replays without capturing again."""
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.explore import objectives as PO
    from esr_tpu_torch.explore.z_optimizer import ZSearch
    from esr_tpu_torch.models import define_G

    g = define_G(_nb2_options(".", network_G={"nf": 64, "nb": 1, "gc": 32, "num_latent_channels": 1}),
                 device=cuda, seed=0).requires_grad_(False)
    g.prepare_kernels()
    cem = make_cem(CEMConf(scale=4), device=cuda)

    def forward(lr, z):
        return cem.project(g(lr, z), lr)

    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.random((1, 16, 16, 3), dtype=np.float32)).to(cuda)
    z0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 16, 16, 1)).astype(np.float32)).to(cuda)
    mask = torch.ones(64, 64, device=cuda)
    obj = PO.variance_objective(1.0)
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for graphed in (True, False):
            search = ZSearch(forward, lr, z0, mask, obj.fn, obj.aux)
            search.step.enabled = graphed
            search.set_round(1.0)
            before = [c.count for c in _COUNTERS]
            losses = search.run(6, lambda count: 0.1)
            torch.cuda.synchronize()
            assert [c.count - n for c, n in zip(_COUNTERS, before)] == [18, 24, 12]
            out.append((losses.clone(), search.z.clone(), search.best_z.clone(), search))
        (lg, zg, bg, sg), (le, ze, be, _) = out
        assert torch.equal(lg, le) and torch.equal(zg, ze) and torch.equal(bg, be)
        graph = sg.step.graph
        sg.load(lr, z0, mask, obj.aux)
        sg.set_round(1.0)
        assert torch.equal(sg.run(6, lambda count: 0.1), lg) and sg.step.graph is graph
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_cuda_graph_capture_error_raises(cuda):
    """A step that reads a value back to the host mid-step cannot be
    captured: the helper raises with the reason after the eager warm-up, and
    counts nothing for the capture."""
    from esr_tpu_torch.ops.cuda.lib import LaunchCounter
    from esr_tpu_torch.utils.graphs import GraphedStep

    x = torch.ones(4, device=cuda)
    counter = LaunchCounter("test_capture")

    def step():
        counter.count += 1
        return x * float(x.sum())

    try:
        with pytest.raises(RuntimeError, match="host sync: CUDA graph capture failed"):
            GraphedStep(step, cuda, "host sync")()
        assert counter.count == 1  # the warm-up ran; the capture counted nothing
        assert torch.equal(x * 2, torch.full((4,), 2.0, device=cuda))  # the card still works
    finally:
        LaunchCounter.all.remove(counter)


@pytest.mark.cuda
def test_cuda_eval_forward_graph_equals_eager(cuda):
    """The eval forward as a CUDA graph per input shape against the same
    forward eagerly, at two shapes (with Z, and Z None), cuDNN deterministic:
    bit for bit on the capture call and on two replays each, 6 / 4 / 2
    launches a replay, one graph per shape; after prepare_kernels (new
    layouts) the graphs are dropped and the answer is still the eager one."""
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.models import define_G, make_eval_forward

    g = define_G(_nb2_options("."), device=cuda, seed=0)
    cem = make_cem(CEMConf(scale=4), device=cuda)
    fwd, eager = make_eval_forward(g, cem), make_eval_forward(g, cem, graphs=False)
    rng = np.random.default_rng(1)
    cases = [(torch.from_numpy(rng.random((1, 24, 20, 3), dtype=np.float32)).to(cuda),
              torch.from_numpy(rng.uniform(-1, 1, (1, 24, 20, 1)).astype(np.float32)).to(cuda)),
             (torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32)).to(cuda), None)]
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(3):
            for lr, z in cases:
                before = [c.count for c in _COUNTERS]
                got = fwd(lr, z)
                torch.cuda.synchronize()
                assert [c.count - n for c, n in zip(_COUNTERS, before)] == [6, 4, 2]
                assert torch.equal(got, eager(lr, z))
        assert len(fwd.graphs.steps) == 2 and all(s.graph is not None for s in fwd.graphs.steps)
        g.prepare_kernels()
        lr, z = cases[0]
        assert torch.equal(fwd(lr, z), eager(lr, z)) and len(fwd.graphs.steps) == 1
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
@pytest.mark.parametrize("supervised", [False, True], ids=["adversarial", "override"])
def test_cuda_kernelgan_graph_equals_eager(cuda, supervised):
    """150 KernelGAN iterations (chunks of 100 and 50) with each iteration a
    replay of one CUDA graph against the same loop eagerly, cuDNN
    deterministic: the kernel and the metrics of both chunks bit for bit."""
    import torch.nn.functional as F

    from esr_tpu_torch.cem import kernelgan
    from esr_tpu_torch.utils.graphs import GraphedStep

    img = np.random.default_rng(3).random((72, 80)).astype(np.float32)
    conf = kernelgan.KernelGANConf(iters=150)

    def loss(fake, g_in):
        return F.mse_loss(fake, 0.5 * g_in[:, 10::4, 10::4][:, : fake.shape[1], : fake.shape[2]])

    torch.backends.cudnn.deterministic = True
    try:
        init = GraphedStep.__init__

        def eager_init(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.enabled = False

        runs = []
        for graphed in (True, False):
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                if not graphed:  # the same loop, every iteration eagerly
                    mp.setattr(GraphedStep, "__init__", eager_init)
                k, m = kernelgan.estimate_kernel(img, conf, progress=lambda *a: calls.append(a),
                                                 loss_override=loss if supervised else None, device=cuda)
            runs.append((k, m, calls))
        (kg_, mg, cg), (ke, me, ce) = runs
        assert np.array_equal(kg_, ke) and mg == me and cg == ce and [c[0] for c in cg] == [100, 150]
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_cuda_served_answers_equal_the_live_forward(cuda, tmp_path):
    """make_server's warm-up captures one graph per bucket; later answers
    (replays) equal the eager forward on the edge-padded LR byte for byte."""
    from esr_tpu_torch.export import export_servable
    from esr_tpu_torch.models import create_model, make_eval_forward
    from esr_tpu_torch.options import parse
    from esr_tpu_torch.scripts.serve import make_server

    model = create_model(parse(_nb2_options(tmp_path), is_train=False))
    export_servable(model, [(1, 16, 16), (1, 32, 32)], str(tmp_path / "art"))
    server = make_server(str(tmp_path / "art"), "127.0.0.1", 0)
    try:
        sv = server.servable
        assert len(sv.forward.graphs.steps) == 2 and all(s.graph is not None for s in sv.forward.graphs.steps)
        live = make_eval_forward(model.g_module, model.cem, graphs=False)
        rng = np.random.default_rng(4)
        for h, w in ((16, 16), (24, 19), (32, 32)):
            lr = rng.random((1, h, w, 3)).astype(np.float32)
            z = rng.uniform(-1, 1, (1, h, w, 1)).astype(np.float32)
            _, bh, bw = sv._bucket_for(1, h, w)
            pad = ((0, 0), (0, bh - h), (0, bw - w), (0, 0))
            want = live(torch.from_numpy(np.pad(lr, pad, mode="edge")).to(cuda),
                        torch.from_numpy(np.pad(z, pad, mode="edge")).to(cuda))[:, : 4 * h, : 4 * w]
            np.testing.assert_array_equal(sv.sr(lr, z), want.cpu().numpy())
        assert len(sv.forward.graphs.steps) == 2
    finally:
        server.server_close()
