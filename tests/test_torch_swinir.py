"""The port's SwinIR (``models/architecture.py``) and its window-attention
kernel (``ops/cuda/window_attn.py``), and the conv kernel's Cin 129-192.

CPU: the plain path (SwinIR behind the CEM) against the benchmark's plain
reference (``esr_bench/reference/swinir.py``, written from the paper and the
released code) at a toy size, f32, 1e-5 (the two sum the same products in
the same order but for the CEM's and the GEMMs' blocking); the released
keys; a mirror of the kernel's index arithmetic against roll + partition +
SwinIR's mask; the Cin 180 weight image. Neither side imports JAX.

Card (skip without one; run as ``tests/torch_card.py`` says): the attention
kernel against its plain version at SwinIR-M's head dim 30, window 8, B2
and B4 x 344 x 512, both shifts; the conv kernel at 180 -> 180 and 180 ->
64 (slope 0.01); SwinIR-M's eval forward as a CUDA graph on the kernels, at
B1 and at the ``swinir_eval_div2k_b4`` cell's shape. Their times are the
cell's.
"""

import json

import pytest
import torch

from esr_bench.reference import swinir as ref_swinir
from esr_bench.reference.cem import Cem
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.models import make_eval_forward
from esr_tpu_torch.models.networks import define_G, normalize_swinir_keys
from esr_tpu_torch.ops.cuda import kpack_conv, layernorm, token_linear, window_attn
from torch_card import REPO, cuda  # noqa: F401

TOY = {"scale": 4, "bf16": False, "network_G": {
    "which_model_G": "SwinIR", "upscale": 4, "in_chans": 3, "img_size": 64, "window_size": 4, "img_range": 1.0,
    "depths": [2, 2], "embed_dim": 12, "num_heads": [2, 2], "mlp_ratio": 2, "upsampler": "nearest+conv",
    "resi_connection": "1conv"}}
M = {"scale": 4, "bf16": True, "network_G": dict(TOY["network_G"], window_size=8, depths=[6] * 6, embed_dim=180,
                                                 num_heads=[6] * 6)}


def seeded_state(cfg, seed=0, device="cpu"):
    """Weights as the benchmark draws them (``generator_shapes``' gains), the
    LayerNorm weights 1 + noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for key, (shape, gain) in ref_swinir.generator_shapes(cfg).items():
        fan = torch.tensor(shape[1:]).prod().item() if len(shape) > 1 else 0
        std = gain * (2.0 / fan) ** 0.5 if len(shape) > 1 else gain
        t = torch.randn(shape, generator=g, device=device) * std
        out[key] = t + 1.0 if key.endswith(("norm.weight", "norm1.weight", "norm2.weight")) else t
    return out


def test_plain_path_and_cem_match_the_reference():
    """LR 10 x 13 reflect-pads to 12 x 16 at window 4, so both shifts and
    the shifted windows' mask occur."""
    sd = seeded_state(TOY)
    g = define_G(TOY, device="cpu")
    g.load_state_dict(sd, strict=True)
    lr = torch.rand(2, 10, 13, 3, generator=torch.Generator().manual_seed(1))
    cem = make_cem(CEMConf(scale=4), device="cpu")
    with torch.no_grad():
        port = cem.project(g(lr), lr)
        mine = Cem(4, "cpu").project(ref_swinir.generator(sd, TOY, lr), lr)
    assert port.shape == (2, 40, 52, 3)
    torch.testing.assert_close(port, mine, atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # the eval forward (eager on the CPU) gives the same answer
        torch.testing.assert_close(make_eval_forward(g, cem)(lr), port, atol=0, rtol=0)


def test_released_keys_load_with_the_wrapper_and_buffers_dropped():
    sd = seeded_state(TOY)
    buffers = {}
    for layer in range(2):
        for i in range(2):
            b = f"layers.{layer}.residual_group.blocks.{i}"
            buffers[f"{b}.attn.relative_position_index"] = torch.zeros(16, 16, dtype=torch.long)
            if i % 2:
                buffers[f"{b}.attn_mask"] = torch.zeros(12, 16, 16)
    released = {"params_ema": {**sd, **buffers}, "params": {}}
    state = normalize_swinir_keys(released)
    assert set(state) == set(sd)
    g = define_G(TOY, device="cpu")
    g.load_state_dict(state, strict=True)
    assert set(g.state_dict()) == set(sd)
    assert normalize_swinir_keys({"params": sd}).keys() == sd.keys()


def window_tokens(h, w, ws, shift):
    """The kernel's index arithmetic (``csrc/window_attn.cu``): window (wy,
    wx)'s token i is the pixel ((ws wy + i / ws + shift) % h, (ws wx + i % ws
    + shift) % w), as a pixel index y w + x; (windows, ws^2)."""
    wy, wx = torch.arange(h // ws)[:, None, None, None], torch.arange(w // ws)[None, :, None, None]
    i = torch.arange(ws * ws)
    y = (wy * ws + (i // ws)[None, None, None, :] + shift) % h
    x = (wx * ws + (i % ws)[None, None, None, :] + shift) % w
    return (y * w + x).reshape(-1, ws * ws)


def window_regions(h, w, ws, shift):
    """The kernel's region id of each window's tokens from their rolled
    coordinates (sy, sx): 3 ry + rx, r = 0 below h - ws, 1 below h - shift,
    else 2; 0 everywhere at shift 0."""
    if shift == 0:
        return torch.zeros((h // ws) * (w // ws), ws * ws, dtype=torch.long)
    wy, wx = torch.arange(h // ws)[:, None, None], torch.arange(w // ws)[None, :, None]
    i = torch.arange(ws * ws)[None, None, :]
    sy, sx = wy * ws + i // ws, wx * ws + i % ws
    ry = (sy >= h - ws).long() + (sy >= h - shift).long()
    rx = (sx >= w - ws).long() + (sx >= w - shift).long()
    return (ry * 3 + rx).reshape(-1, ws * ws)


@pytest.mark.parametrize("h,w", [(16, 24), (24, 16), (8, 40)])
@pytest.mark.parametrize("shift", [0, 4])
def test_kernel_index_arithmetic_is_roll_partition_and_mask(h, w, shift):
    """The kernel's token of (window, i) and region ids equal roll(-shift) +
    window partition of the pixel indices and SwinIR's calculate_mask, at
    window 8 on non-square maps."""
    ws = 8
    pix = torch.arange(h * w).view(1, h, w, 1)
    rolled = torch.roll(pix, (-shift, -shift), (1, 2)) if shift else pix
    part = rolled.view(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    assert torch.equal(window_tokens(h, w, ws, shift), part)
    reg = window_regions(h, w, ws, shift)
    mask = torch.where(reg[:, None, :] != reg[:, :, None], -100.0, 0.0)
    if shift:
        assert torch.equal(mask, ref_swinir.shift_mask(h, w, ws, shift))
        assert torch.equal(window_attn.shift_mask(h, w, ws, shift), mask)
    else:
        assert not mask.any()


def test_dense_bias_is_the_released_index():
    table = torch.randn(15 * 15, 6)
    dense = window_attn.relative_bias(table, 8)
    assert dense.shape == (6, 64, 64)
    torch.testing.assert_close(dense, ref_swinir.relative_bias(table, 8), atol=0, rtol=0)
    # token (0, 0) against token (7, 7): dy = dx = -7, row 0 of the table
    assert torch.equal(dense[:, 0, 63], table[0]) and torch.equal(dense[:, 63, 0], table[-1])


def test_conv_weights_build_a_three_chunk_image_for_cin_180():
    """Cin 180 takes three K chunks of 64 (cin_pad 192), the image decoding
    back to the HWIO kernel chunk by chunk, zeros in channels 180-191 and in
    Cout 180-191; the 2x2 mode, Cout <= 8 and a Cin not a multiple of 4 raise."""
    w = torch.randn(3, 3, 180, 180)
    kw = kpack_conv.conv_kernel_weights(w, torch.ones(180), torch.bfloat16, torch.device("cpu"))
    assert (kw.route, kw.cin_pad, kw.cout_pad) == ("tc", 192, 192)
    img = kpack_conv.sw128_rows(kw.wt.float().reshape(-1, 64, 64)).reshape(3, 3, 9, 64, 64)  # slice, chunk, tap, N, K
    want = torch.nn.functional.pad(w.bfloat16().float().reshape(9, 180, 180), (0, 12, 0, 12))  # tap, K, N
    got = img.permute(2, 1, 4, 0, 3).reshape(9, 192, 192)
    assert torch.equal(got, want)
    assert kpack_conv._fuses_slope(kw, 0.01) and not kpack_conv._fuses_slope(
        kpack_conv.conv_kernel_weights(torch.randn(3, 3, 64, 64), None, torch.bfloat16, torch.device("cpu")), 0.01)
    for shape, ksize in (((3, 3, 180, 64), 2), ((3, 3, 180, 3), 3), ((3, 3, 130, 64), 3)):
        with pytest.raises(ValueError, match="Cin up to 128"):
            kpack_conv.conv_kernel_weights(torch.zeros(shape), None, torch.bfloat16, torch.device("cpu"), ksize)


def test_sloped_conv_runs_its_lrelu_where_the_epilogue_does_not():
    """conv_before_upsample's LeakyReLU(0.01), passed to the conv: on the
    CPU the plain conv's epilogue; on the card the Cin 129-192 kernel's, and
    ``conv_launch`` raises for weights whose epilogue does not take it."""
    from esr_tpu_torch.models.blocks import ConvLRelu

    conv = ConvLRelu(12, 8, act=True, slope=0.01, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 5, 6, 12)
    with torch.no_grad():
        want = torch.nn.functional.leaky_relu(
            kpack_conv.conv3x3_reference(x, conv.hwio(), conv.bias, False), 0.01)
        torch.testing.assert_close(conv(x), want, atol=1e-6, rtol=0)


def _swinir_opt(tmp_path, **extra):
    """The shipped test options (``options/test/test_SwinIR_M_x4.json``) at the toy widths, f32, on a
    SYNTHETIC set of two images."""
    import json
    from pathlib import Path

    import esr_tpu_torch

    opt = json.loads((Path(esr_tpu_torch.__file__).parent / "options/test/test_SwinIR_M_x4.json").read_text())
    assert opt["network_G"] == dict(M["network_G"], depths=[6] * 6, num_heads=[6] * 6)
    opt.update(bf16=False, watchdog=False)
    opt["network_G"] = dict(TOY["network_G"])
    opt["path"] = {"root": str(tmp_path), "pretrain_model_G": extra.get("pth")}
    opt["datasets"] = {"test_1": {"name": "syn", "mode": "SYNTHETIC", "n_images": 2, "image_size": 52}}
    path = tmp_path / "opt.json"
    path.write_text(json.dumps(opt))
    return path


def test_eval_cli_runs_the_swinir_options(tmp_path):
    """test.py with the SwinIR options (toy widths, a released-style
    ``params_ema`` file as its weights): the CEM keeps every answer
    consistent with its LR."""
    from esr_tpu_torch import test as test_cli

    pth = tmp_path / "G.pth"
    torch.save({"params_ema": seeded_state(TOY)}, pth)
    out = test_cli.main(["-opt", str(_swinir_opt(tmp_path, pth=str(pth))), "--device", "cpu"])
    assert out["syn"]["cem_residual"] < 1e-4 and out["syn"]["psnr"] > 0


def test_exported_swinir_serves_one_bucket(tmp_path):
    """An exported toy SwinIR answers an LR of its bucket as the live eval forward does."""
    from esr_tpu_torch.export import export_servable, load_servable
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    model = create_model(parse(str(_swinir_opt(tmp_path)), is_train=False), device="cpu")
    model.g_module.load_state_dict(seeded_state(TOY, seed=5), strict=True)
    art = str(tmp_path / "artifact")
    export_servable(model, [(1, 12, 16)], art)
    lr = torch.rand(1, 12, 16, 3, generator=torch.Generator().manual_seed(2))
    got = load_servable(art, device="cpu").sr(lr.numpy())
    with torch.no_grad():
        want = make_eval_forward(model.g_module, make_cem(CEMConf(scale=4), device="cpu"))(lr)
    assert got.shape == (1, 48, 64, 3)
    torch.testing.assert_close(torch.from_numpy(got), want, atol=1e-5, rtol=1e-5)


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shift", [0, 4])
def test_cuda_window_attention_matches_plain(cuda, shift, n):
    """B2 and B4 (the ``swinir_eval_div2k_b4`` cell's padded shape) x 344 x
    512, 6 heads of 30, window 8: one launch counted, within twice the bf16
    plain version's own error against the f32 plain version on the same
    bf16 qkv (the kernel rounds P to bf16 for P V and its output to bf16, as
    the plain bf16 version does; sums run in another order), and that error
    under 2% of the output's largest value."""
    g = torch.Generator(device=cuda).manual_seed(shift + n)
    qkv = torch.randn(n, 344, 512, 540, device=cuda, generator=g).bfloat16()
    bias = torch.randn(6, 64, 64, device=cuda, generator=g)
    before = window_attn.LAUNCHES.count
    with torch.no_grad():
        got = window_attn.window_attention(qkv, bias, 6, 8, shift)
    torch.cuda.synchronize()
    assert window_attn.LAUNCHES.count == before + 1
    want = window_attn.window_attention_reference(qkv.float(), bias, 6, 8, shift)
    own = (window_attn.window_attention_reference(qkv, bias, 6, 8, shift).float() - want).abs().max().item()
    err = (got.float() - want).abs().max().item()
    assert got.shape == (n, 344, 512, 180) and err <= 2 * own and err <= 0.02 * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_window_attention_mask_and_shift_matter(cuda):
    """The same qkv at shift 4 and shift 0 differ (by far more than the
    rounding band) in the last window row and column only where the mask
    applies, and everywhere else where the windows move."""
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(1, 64, 96, 540, device=cuda, generator=g).bfloat16()
    bias = torch.zeros(6, 64, 64, device=cuda)
    with torch.no_grad():
        a = window_attn.window_attention(qkv, bias, 6, 8, 4).float()
        b = window_attn.window_attention_reference(qkv.float(), bias, 6, 8, 4)
        c = window_attn.window_attention(qkv, bias, 6, 8, 0).float()
    assert (a - b).abs().max().item() < 0.05 and (a - c).abs().max().item() > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (4, 344, 512)], ids=["ragged", "cell"])
@pytest.mark.parametrize("cout,act", [(180, False), (64, True)])
def test_cuda_conv_cin180_on_tensor_cores(cuda, cout, act, shape):
    """180 -> 180 (three Cout slices: the RSTB convs, conv_after_body) and
    180 -> 64 with LeakyReLU(0.01) (conv_before_upsample) on a ragged batch-2
    grid and at the ``swinir_eval_div2k_b4`` cell's padded shape: one launch
    of the streamed-weight instances, within twice the bf16 plain version's
    error against the f32 plain version (the conv band)."""
    g = torch.Generator(device=cuda).manual_seed(cout + sum(shape))
    x = torch.randn(*shape, 180, device=cuda, generator=g).bfloat16()
    w = torch.randn(3, 3, 180, cout, device=cuda, generator=g) * (2.0 / (9 * 180)) ** 0.5
    b = 0.1 * torch.randn(cout, device=cuda, generator=g)
    before = kpack_conv.LAUNCHES.count
    with torch.no_grad():
        got = kpack_conv.kpack_conv3x3(x, w, b, act, slope=0.01)
    torch.cuda.synchronize()
    assert kpack_conv.LAUNCHES.count == before + 1
    want = kpack_conv.conv3x3_reference(x.float(), w, b, act, 0.01)
    own = (kpack_conv.conv3x3_reference(x, w, b, act, 0.01).float() - want).abs().max().item()
    tol = max(2 * own, 2.0**-6 * want.abs().max().item())
    assert got.shape == want.shape and (got.float() - want).abs().max().item() <= tol
    if act:  # the slope is the epilogue's: where the conv is below -1, the answer is 0.01 of it, not 0.2
        neg = kpack_conv.conv3x3_reference(x.float(), w, b, False) < -1.0
        assert neg.any() and (got.float()[neg] - want[neg]).abs().max().item() < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed,rel_limit,residual_limit", [((1, 45, 62), 3, 0.1, 1e-3), ((4, 339, 510), 14, None, None)],
                         ids=["b1", "cell"])
def test_cuda_swinir_m_eval_forward_runs_on_the_kernels(cuda, shape, seed, rel_limit, residual_limit):
    """SwinIR-M at its published widths and depth behind the CEM, as a CUDA
    graph: 36 window_attn launches a replay, 11 conv3x3, 2 parity, 74
    layernorm, 144 token_linear and no RDB launches; the answer within 10% (relative L2, the
    detail over the consistent upscale) of the f32 reference (TF32 off), and
    consistent to 1e-3; at the ``swinir_eval_div2k_b4`` cell's shape, B4 x LR
    339 x 510 (padded 344 x 512), within the cell's own limits."""
    from esr_bench.traffic.eval import compare
    from esr_tpu_torch.ops.cuda import rdb_conv

    if rel_limit is None:
        limits = json.loads((REPO / "esr_bench" / "workloads" / "swinir_eval_div2k_b4.json").read_text())["limits"]
        rel_limit, residual_limit = limits["sr_rel_err"], limits["cem_residual"]
    sd = seeded_state(M, seed=seed, device=cuda)
    g = define_G(M, device=cuda)
    g.load_state_dict(sd, strict=True)
    fwd = make_eval_forward(g, make_cem(CEMConf(scale=4), device=cuda))
    lr = torch.rand(*shape, 3, device=cuda, generator=torch.Generator(device=cuda).manual_seed(seed))
    fwd(lr)
    counters = (window_attn.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP, layernorm.LAUNCHES,
                token_linear.LAUNCHES, rdb_conv.LAUNCHES)
    before = [c.count for c in counters]
    out = fwd(lr)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [36, 11, 2, 74, 144, 0]
    cem = Cem(4, cuda)
    with torch.no_grad():
        want = cem.project(ref_swinir.generator(sd, M, lr), lr)
    rel, residual = compare(cem, out, want, lr)
    assert out.shape == want.shape and max(rel) < rel_limit and residual < residual_limit, (max(rel), residual)
