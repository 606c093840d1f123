"""The port's CUDA kernels against their plain PyTorch versions, and the
eval and serving entry points through them, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. They import neither JAX nor esr_tpu, so that they run where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

f32 tolerance 1e-4: up to 9 * 192 products summed in another order than
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


@pytest.mark.cuda
@pytest.mark.parametrize("strip,wtile", [(8, 8), (5, 7), (8, 12)])
def test_cuda_rdb5c_matches_plain(cuda, strip, wtile):
    p = _rdb_params(64, 32, cuda)
    x = torch.randn(2, 19, 23, 64, device=cuda)
    before = rdb_conv.LAUNCHES_SIMT["f32"].count
    with torch.no_grad():
        got = rdb_conv.fused_rdb5c_tiled(x, p, strip=strip, wtile=wtile)
    torch.cuda.synchronize()
    assert rdb_conv.LAUNCHES_SIMT["f32"].count == before + 1
    torch.testing.assert_close(got, rdb_conv.rdb5c_reference(x, p), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,act", [(4, 64, False), (64, 64, True), (64, 3, False)])
def test_cuda_conv3x3_matches_plain(cuda, cin, cout, act):
    x = torch.randn(2, 21, 19, cin, device=cuda)
    w = torch.randn(3, 3, cin, cout, device=cuda) * 0.1
    b = torch.randn(cout, device=cuda)
    got = kpack_conv.kpack_conv3x3(x, w, b, act)
    ref = kpack_conv.conv3x3_reference(x, w, b, act)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    up = upsample2x_conv3x3(x, w, b, act)
    ref_up = kpack_conv.conv3x3_reference(upsample_nearest(x, 2), w, b, act)
    torch.testing.assert_close(up, ref_up, atol=1e-4, rtol=0)


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
@pytest.mark.parametrize("nf,gc,shape", [(8, 4, (2, 37, 53)), (16, 8, (1, 45, 30)), (12, 6, (1, 17, 9))])
def test_cuda_rdb5c_bf16_simt_widths_within_band(cuda, nf, gc, shape):
    """bf16 RDBs at widths the tensor-core kernel does not take run the SIMT
    kernel in bf16 (counted under its own route, none under the tensor-core
    one), at the default tile and at another, within twice the bf16 plain
    version's error against the f32 plain version on the same bf16 inputs."""
    p = _rdb_params(nf, gc, cuda, seed=nf)
    x = torch.randn(*shape, nf, device=cuda, generator=torch.Generator(device=cuda).manual_seed(nf)).bfloat16()
    ref = rdb_conv.rdb5c_reference(x.float(), p)
    tol = 2 * (rdb_conv.rdb5c_reference(x, p).float() - ref).abs().max().item()
    simt, tc = rdb_conv.LAUNCHES_SIMT["bf16"], rdb_conv.LAUNCHES
    before = (simt.count, tc.count)
    with torch.no_grad():
        outs = [rdb_conv.fused_rdb5c(x, p), rdb_conv.fused_rdb5c_tiled(x, p, strip=8, wtile=12)]
    torch.cuda.synchronize()
    assert (simt.count, tc.count) == (before[0] + 2, before[1])
    for got in outs:
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(128, 128), (64, 96), (128, 3)])
def test_cuda_conv_bf16_simt_wide_within_band(cuda, cin, cout):
    """bf16 convs wider than 64 channels run the SIMT kernel in bf16 in both
    modes (counted under its own route), within the bf16 conv band."""
    g = torch.Generator(device=cuda).manual_seed(cin + cout)
    x = torch.randn(2, 21, 19, cin, device=cuda, generator=g).bfloat16()
    w = torch.randn(3, 3, cin, cout, device=cuda, generator=g) * (2.0 / (9 * cin)) ** 0.5
    b = 0.1 * torch.randn(cout, device=cuda, generator=g)
    for ksize, fn, plain in ((3, kpack_conv.kpack_conv3x3, kpack_conv.conv3x3_reference),
                             (2, upsample2x_conv3x3, upsample2x_conv3x3_reference)):
        counter = kpack_conv.LAUNCHES_SIMT[(ksize, "bf16")]
        before = counter.count
        with torch.no_grad():
            got = fn(x, w, b, True)
        torch.cuda.synchronize()
        assert counter.count == before + 1
        ref = plain(x.float(), w, b, True)
        tol = max(2 * (plain(x, w, b, True).float() - ref).abs().max().item(), 2.0**-6 * ref.abs().max().item())
        assert got.shape == ref.shape and (got.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_bf16_small_model_runs_on_the_kernels(cuda):
    """A bf16 generator at nf 8, gc 4 (the widths of `__graft_entry__.py`'s dryrun) runs on the
    card: RDBs on the bf16 SIMT kernel, convs on the tensor-core one, and
    its answer is finite."""
    from esr_tpu_torch.models import define_G, make_eval_forward

    opt = {"network_G": {"nf": 8, "nb": 2, "gc": 4, "num_latent_channels": 1}, "scale": 4, "bf16": True}
    g = define_G(opt, device=cuda, seed=3)
    lr = torch.rand(1, 20, 24, 3, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    before = (rdb_conv.LAUNCHES_SIMT["bf16"].count, kpack_conv.LAUNCHES.count)
    out = make_eval_forward(g)(lr)
    torch.cuda.synchronize()
    assert (rdb_conv.LAUNCHES_SIMT["bf16"].count - before[0], kpack_conv.LAUNCHES.count - before[1]) == (6, 4)
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
    gc 32) in bf16 on the card: every 3x3 conv and RDB on its kernel (SRResNet's
    64 -> 256 upconvs on the bf16 SIMT route), and the answer within twice the
    bf16 plain path's relative L2 from the f32 plain path (the same weights
    on the CPU)."""
    from esr_tpu_torch.models import define_G

    net = {"nf": 64, "nb": 2, "num_latent_channels": 1}
    net.update({"which_model_G": "sr_resnet"} if which == "sr_resnet" else {"gc": 32, "latent_input": "all_layers"})
    opt = {"network_G": net, "scale": 4, "bf16": True}
    g = define_G(opt, device=cuda, seed=5)
    g.prepare_kernels()
    gen = torch.Generator().manual_seed(5)
    lr = torch.rand(1, 16, 20, 3, generator=gen)
    z = torch.rand(1, 16, 20, 1, generator=gen) * 2 - 1
    simt = kpack_conv.LAUNCHES_SIMT[(3, "bf16")]
    counters = _COUNTERS + (simt,)
    for c in counters:
        c.reset()
    with torch.no_grad():
        got = g(lr.to(cuda), z.to(cuda)).cpu()
        torch.cuda.synchronize()
        counts = [c.count for c in counters]
        plain = {bf16: define_G(dict(opt, bf16=bf16), device="cpu", seed=5)(lr, z) for bf16 in (True, False)}
    assert counts == ([0, 8, 0, 2] if which == "sr_resnet" else [6, 4, 2, 0]), counts
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
