"""The port's repairs, on the CPU: a weight load rebuilds the eval forward
and drops the kernels' layouts; the synthetic dataset's image cache is
bounded; a frozen block hands its prebuilt layout to the kernel's autograd
Function, which then builds none and differentiates only the input.

The card-side halves (load B == fresh on B bit for bit, the bf16 RDB and
the wide bf16 convs at other widths on the tensor-core kernels, a frozen Z
step through the kernels) are in tests/test_torch_cuda.py."""

import numpy as np
import torch

from esr_tpu_torch.data.lrhr_dataset import SyntheticDataset
from esr_tpu_torch.models import create_model, define_G
from esr_tpu_torch.ops.cuda import autograd as fns
from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv
from esr_tpu_torch.ops.fused import upsample2x_conv3x3_reference
from esr_tpu_torch.options import parse

torch.set_num_threads(1)

OPT = {"name": "repairs", "model": "sr", "scale": 4, "use_cem": True, "bf16": False,
       "network_G": {"nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1}}


def test_load_network_rebuilds_forward_and_drops_layouts(tmp_path):
    """After ``load_network`` the eval forward is a new one and no module keeps
    a layout of the old weights (on the CPU: none at all); the model then
    answers as a fresh model on the loaded weights."""
    path_a, path_b = str(tmp_path / "A.pth"), str(tmp_path / "B.pth")
    for seed, path in ((1, path_a), (2, path_b)):
        torch.save(define_G(OPT, device="cpu", seed=seed).state_dict(), path)
    opt = dict(OPT, path={"root": str(tmp_path), "pretrain_model_G": path_a})
    model = create_model(parse(opt, is_train=False), device="cpu")
    old_forward = model._forward
    stale = object()
    modules = [m for m in model.g_module.modules() if hasattr(m, "prepare_kernel")]
    for m in modules:  # stand-ins for layouts of the old weights
        m.kernel_weights = stale
    model.load_network(path_b)
    assert model._forward is not old_forward
    assert all(m.kernel_weights is None for m in modules)
    data = {"LR": np.random.default_rng(0).random((6, 5, 3)).astype(np.float32)}
    fresh = create_model(parse(dict(opt, path=dict(opt["path"], pretrain_model_G=path_b)), is_train=False),
                         device="cpu")
    outs = []
    for m in (model, fresh):
        m.feed_data(data)
        m.test()
        outs.append(m.get_visuals_device()["SR"])
    assert torch.equal(outs[0], outs[1])


def test_trainer_load_network_keeps_no_forward(tmp_path):
    """A trainer has no eval forward to rebuild: ``load_network`` leaves it None."""
    path = str(tmp_path / "G.pth")
    torch.save(define_G(OPT, device="cpu", seed=1).state_dict(), path)
    opt = dict(OPT, path={"root": str(tmp_path)}, datasets={"train": {"mode": "SYNTHETIC", "HR_size": 32}})
    model = create_model(parse(opt, is_train=True), device="cpu")
    model.load_network(path)
    assert model._forward is None
    assert torch.equal(model.g_module.conv_first.weight, torch.load(path)["conv_first.weight"])


def test_synthetic_cache_is_bounded_and_eviction_changes_nothing():
    """The port's SyntheticDataset keeps at most CACHE_IMAGES images (LRU; a
    deliberate divergence from the JAX package's unbounded dict), and an image
    made again after its eviction is the same, bit for bit."""
    cap = SyntheticDataset.CACHE_IMAGES
    ds = SyntheticDataset({"phase": "test", "n_images": cap + 8, "image_size": 24})
    first = ds._make_image(0).copy()
    for i in range(cap + 8):
        ds._make_image(i)
        assert len(ds._img_cache) <= cap
    assert 0 not in ds._img_cache
    assert np.array_equal(ds._make_image(0), first)
    ds._make_image(5)  # a hit moves the image to the back: the oldest goes next
    ds._make_image(cap + 100)
    assert 5 in ds._img_cache
    big = SyntheticDataset({"phase": "test", "n_images": 3, "image_size": 24})
    for i in range(3):
        assert np.array_equal(big[i]["HR"], ds[i]["HR"])


def _rdb_params(nf, gc, seed):
    g = torch.Generator().manual_seed(seed)
    p = {}
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        p[f"w{k}"] = torch.randn(3, 3, cin, cout, generator=g) * (0.3 / cin**0.5)
        p[f"b{k}"] = 0.1 * torch.randn(cout, generator=g)
    return p


def test_functions_take_a_prebuilt_layout(monkeypatch):
    """Given a prebuilt layout, each kernel's Function launches on it, builds
    none, and its backward (the plain recompute) gives the input's gradient
    of the plain version and none for the frozen weights. The launches are
    stood in for by the plain versions (no CUDA here)."""
    got_layouts = []

    def rdb_launch(x, kw):
        got_layouts.append(kw)
        return rdb_conv.rdb5c_reference(x, params)

    def conv_launch(x, kw, act):
        got_layouts.append(kw)
        plain = kpack_conv.conv3x3_reference if kw.ksize == 3 else upsample2x_conv3x3_reference
        return plain(x, kernel, bias, act)

    monkeypatch.setattr(fns, "rdb5c_launch", rdb_launch)
    monkeypatch.setattr(fns, "conv_launch", conv_launch)
    params = _rdb_params(8, 4, 0)
    kw = rdb_conv.rdb5c_kernel_weights(params, torch.float32, torch.device("cpu"))
    builds = rdb_conv.LAYOUTS.count
    x = torch.randn(1, 6, 7, 8, requires_grad=True)
    y = fns.rdb5c_fn(x, params, kw)
    assert got_layouts == [kw] and rdb_conv.LAYOUTS.count == builds
    gy = torch.randn_like(y)
    (gx,) = torch.autograd.grad(y, x, gy)
    xr = x.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(rdb_conv.rdb5c_reference(xr, params), xr, gy)
    torch.testing.assert_close(gx, want)
    g = torch.Generator().manual_seed(1)
    kernel, bias = torch.randn(3, 3, 8, 5, generator=g) * 0.2, torch.randn(5, generator=g)
    for fn, ksize, plain in ((fns.conv3x3_fn, 3, kpack_conv.conv3x3_reference),
                             (fns.upsample2x_conv3x3_fn, 2, upsample2x_conv3x3_reference)):
        ckw = kpack_conv.conv_kernel_weights(kernel, bias, torch.float32, torch.device("cpu"), ksize)
        builds = kpack_conv.LAYOUTS.count
        y = fn(x, kernel, bias, True, ckw)
        assert got_layouts[-1] is ckw and kpack_conv.LAYOUTS.count == builds
        gy = torch.randn_like(y)
        (gx,) = torch.autograd.grad(y, x, gy)
        (want,) = torch.autograd.grad(plain(xr, kernel, bias, True), xr, gy)
        torch.testing.assert_close(gx, want)


def test_blocks_pass_the_layout_only_when_frozen():
    """A block hands its prebuilt layout to the Function when none of its
    parameters needs a gradient; with trainable weights, or no layout, it
    hands none (the Function builds one from the live weights)."""
    from esr_tpu_torch.models.blocks import _frozen_layout

    g = define_G(OPT, device="cpu")
    rdb, conv = g.RRDB_trunk[0].RDB1, g.conv_first
    marker = object()
    for m in (rdb, conv):
        m.kernel_weights = marker
        assert _frozen_layout(m) is None  # trainable
    g.requires_grad_(False)
    assert _frozen_layout(rdb) is marker and _frozen_layout(conv) is marker
    g.release_kernels()
    assert _frozen_layout(rdb) is None
