"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. They import neither JAX nor esr_tpu, so that they run where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

f32 tolerance 1e-4: up to 9 * 192 products summed in another order than
cuDNN's (TF32 off). bf16: within twice the bf16 plain version's own error
against the f32 plain version.
"""

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
    before = rdb_conv.LAUNCHES.count
    with torch.no_grad():
        got = rdb_conv.fused_rdb5c_tiled(x, p, strip=strip, wtile=wtile)
    torch.cuda.synchronize()
    assert rdb_conv.LAUNCHES.count == before + 1
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
def test_cuda_rdb5c_bf16_within_band(cuda):
    p = _rdb_params(64, 32, cuda)
    x = torch.randn(2, 21, 37, 64, device=cuda).bfloat16()
    ref = rdb_conv.rdb5c_reference(x.float(), p)
    plain_err = (rdb_conv.rdb5c_reference(x, p).float() - ref).abs().max().item()
    with torch.no_grad():
        for strip, wtile in ((16, 16), (12, 8)):
            err = (rdb_conv.fused_rdb5c_tiled(x, p, strip=strip, wtile=wtile).float() - ref).abs().max().item()
            assert err <= 2 * plain_err, (strip, wtile, err, plain_err)


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
