"""The CEM-wrapped flagship forward on the card (RRDBNet nf 64, nb 23, gc
32, x4, one Z channel; seeded Kaiming weights): requests through the bf16
kernels held to the f32 plain path (PSNR beside the bf16 plain path's, CEM
residual, launches); the f32 route's forward (``"bf16": false``) within
F32_TOL of the f32 plain path, a band that the plain path with cuDNN's TF32
on misses; the RDB kernel's other instances on whole generators; and the
forward as one CUDA graph per input shape against the same forward eagerly.
Their times are the ``esr_eval_b16_lr128`` cell's.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.models import define_G, make_eval_forward
from esr_tpu_torch.ops import tensor2img
from torch_card import (ALL_COUNTERS, B, CEM_TOL, EXPECTED_PER_FORWARD, F32_TOL, GC, LR, NB, NF, NZ,
                        PSNR_MARGIN_DB, SCALE, card, check_variant_forward, counted, cuda, max_err, plain_path,  # noqa: F401
                        psnr, traced)

FLAGSHIP = {"network_G": {"which_model_G": "RRDB_net", "nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ},
            "scale": SCALE, "bf16": True}


@pytest.fixture(scope="module")
def flagship():
    """The seed-0 flagship in bf16 and its CEM-wrapped forward."""
    card()
    g = define_G(FLAGSHIP, device="cuda", seed=0)
    cem = make_cem(CEMConf(scale=SCALE), device="cuda")
    return g, cem, make_eval_forward(g, cem)


def _request(n, h, w, z_seed):
    """An LR of ``n`` x ``h`` x ``w``, seeded, and its Z: None, zeros, or a
    random draw as a request's X-Z-Seed makes it."""
    lr = torch.from_numpy(np.random.default_rng(h * w + n).random((n, h, w, 3), dtype=np.float32)).cuda()
    if z_seed in (None, "zeros"):
        return lr, None if z_seed is None else torch.zeros(n, h, w, NZ, device="cuda")
    z = np.random.default_rng(z_seed).uniform(-1, 1, (n, h, w, NZ)).astype(np.float32)
    return lr, torch.from_numpy(z).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,z_seed", [(1, 64, 64, None), (1, 96, 80, 1), (1, 96, 80, 2), (4, 64, 64, "zeros")],
                         ids=["64x64-zeros", "96x80-seed1", "96x80-seed2", "b4-64x64-zeros"])
@torch.no_grad()
def test_cuda_flagship_answers_requests(flagship, n, h, w, z_seed):
    """The answer's shape, every value finite, CEM residual within CEM_TOL,
    69 / 4 / 2 launches, PSNR against the f32 plain path at most
    PSNR_MARGIN_DB below the bf16 plain path's, and a uint8 image of the
    answer's shape."""
    g, cem, fwd = flagship
    lr, z = _request(n, h, w, z_seed)
    out, launches = counted(lambda: fwd(lr, z))
    assert tuple(out.shape) == (n, SCALE * h, SCALE * w, 3)
    assert bool(torch.isfinite(out).all())
    assert max_err(cem.downsample(out), lr) <= CEM_TOL
    assert launches == EXPECTED_PER_FORWARD
    ref32 = plain_path(g, cem, torch.float32)(lr, z)
    pk, pp = psnr(out, ref32), psnr(plain_path(g, cem, torch.bfloat16)(lr, z), ref32)
    assert pk >= pp - PSNR_MARGIN_DB, (pk, pp)
    img = tensor2img(out[:1])
    assert img.dtype == np.uint8 and img.shape == (SCALE * h, SCALE * w, 3)


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_flagship_z_seeds_differ(flagship):
    _, _, fwd = flagship
    a, b = fwd(*_request(1, 96, 80, 1)), fwd(*_request(1, 96, 80, 2))
    assert max_err(a, b) > 1e-3


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_f32_kernel_forward_matches_the_f32_plain_forward(cuda):
    """nb 2, f32 (the f32 route), 2 x LR 40 x 36: within F32_TOL."""
    g = define_G(dict(FLAGSHIP, network_G=dict(FLAGSHIP["network_G"], nb=2), bf16=False), device="cuda", seed=1)
    cem = make_cem(CEMConf(scale=SCALE), device="cuda")
    lr, z = _request(2, 40, 36, 3)
    assert max_err(make_eval_forward(g, cem)(lr, z), plain_path(g, cem, torch.float32)(lr, z)) <= F32_TOL


# the f32 route's path: the flagship forward with "bf16": false, per forward:
# calls of each f32 route, and conv_f32_kernel's launches (five an RDB)
F32_PER_FORWARD = {"rdb5c_f32": 3 * NB, "conv3x3_f32": 4, "upsample2x_conv3x3_f32": 2,
                   "conv_f32_kernel": 5 * 3 * NB + 4 + 2}


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_f32_flagship_forward(cuda):
    """The CEM-wrapped flagship with ``"bf16": false`` (what the JAX package
    evaluates at ``eval_precision: "highest"``) at B16 x LR 128, its layouts
    built once: on one forward its launches on the f32 counters (69 RDBs,
    4 + 2 convs, 351 conv_f32_kernel launches) and none on the bf16 ones, the
    answer's shape and finiteness, the CEM residual, and its max error
    against the f32 plain path within F32_TOL, a band that the same plain
    path with cuDNN's TF32 on misses by 4x or more."""
    g = define_G(dict(FLAGSHIP, bf16=False), device="cuda", seed=0)
    cem = make_cem(CEMConf(scale=SCALE), device="cuda")
    lr = torch.rand(B, LR, LR, 3, generator=torch.Generator().manual_seed(0)).cuda()
    z = torch.zeros(B, LR, LR, NZ, device="cuda")
    out, launches = counted(lambda: make_eval_forward(g, cem)(lr, z), ALL_COUNTERS)
    assert launches == {c.name: F32_PER_FORWARD.get(c.name, 0) for c in ALL_COUNTERS}
    assert all(launches[k] for k in F32_PER_FORWARD)
    assert tuple(out.shape) == (B, SCALE * LR, SCALE * LR, 3) and bool(torch.isfinite(out).all())
    assert max_err(cem.downsample(out), lr) <= CEM_TOL
    plain = plain_path(g, cem, torch.float32)
    ref = plain(lr, z)
    err = max_err(out, ref)
    del out
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=True):
        tf32_err = max_err(plain(lr, z), ref)
    assert err <= F32_TOL and 4 * F32_TOL <= tf32_err, (err, tf32_err)


@pytest.mark.cuda
@pytest.mark.parametrize("nf,gc,batch", [(32, 16, B), (128, 64, 4)])
def test_cuda_generator_on_the_other_rdb_instances(cuda, nf, gc, batch):
    """The CEM-wrapped RRDBNet at nb 23 and the RDB kernel's other instances'
    widths, nf 32 / gc 16 at B16 x LR 128 and nf 128 / gc 64 at B4: 69 / 4 /
    2 launches, PSNR within the variants' band, the CEM residual within
    CEM_TOL or the bf16 plain path's own (the seeded nf 32 generator's
    outputs, up to ~34, take CEM's f32 projection to ~1.1e-5 on the plain
    path too)."""
    opt = {"network_G": {"nf": nf, "nb": NB, "gc": gc, "num_latent_channels": NZ}, "scale": SCALE, "bf16": True}
    check_variant_forward(define_G(opt, device="cuda", seed=0), EXPECTED_PER_FORWARD, batch, residual_as_plain=True)


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_flagship_forward_graph_trace(flagship):
    """A profiler trace of one B16 x LR 128 forward replay holds the kernel
    events of an eager forward (69 rdb5c_tc_kernel, 6 conv_tc_kernel) from
    one graph launch."""
    g, cem, graphed = flagship
    eager = make_eval_forward(g, cem, graphs=False)
    lr = torch.rand(B, LR, LR, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(14))
    z = torch.zeros(B, LR, LR, NZ, device="cuda")
    with tempfile.TemporaryDirectory(prefix="forward_trace_") as d:
        k_replay, split = traced(Path(d), "forward_replay", lambda: graphed(lr, z), lambda: graphed(lr, z))
        k_eager, _ = traced(Path(d), "forward_eager", lambda: eager(lr, z), lambda: eager(lr, z))
    want = {"rdb5c_tc_kernel": 3 * NB, "conv_tc_kernel": 6}
    assert k_replay == k_eager == want and split["graph_launches"] == 1, (k_replay, k_eager, split)


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_stale_layouts_are_caught(cuda):
    """New weights and their layouts (``prepare_kernels``): the forward drops
    its graphs (the layout generation moved) and answers as a fresh eager
    forward bit for bit; and the planted fault, a forward with the
    generation check removed, keeps its graph, which answers with the old
    weights: the comparison with a fresh forward fails it."""
    g = define_G(FLAGSHIP, device="cuda", seed=0)
    cem = make_cem(CEMConf(scale=SCALE), device="cuda")
    lr, z = _request(2, 64, 64, 14)
    kept, checked = make_eval_forward(g, cem), make_eval_forward(g, cem)
    kept._sync_layouts = lambda: None  # the copy with the generation check removed
    old = [kept(lr, z), kept(lr, z), checked(lr, z), checked(lr, z)][-1]
    old_layouts = [m.kernel_weights for m in g._kernel_modules()]  # noqa: F841  (alive: a stale graph reads them)
    g.load_state_dict(define_G(FLAGSHIP, device="cuda", seed=1).state_dict())
    g.prepare_kernels()
    fresh = make_eval_forward(g, cem, graphs=False)(lr, z)
    got, stale = checked(lr, z), kept(lr, z)
    assert torch.equal(got, fresh) and not torch.equal(fresh, old) and len(checked.graphs.steps) == 1
    assert torch.equal(stale, old) and not torch.equal(stale, fresh)
