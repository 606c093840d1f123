"""The port's HAT (``models/architecture.py``), its attention kernel
(``ops/cuda/hat_attn.py``), its channel attention (``ops/cuda/
channel_attn.py``) and the conv kernel's GELU epilogue for the CAB.

CPU: the plain path (HAT behind the CEM) against the benchmark's plain
reference (``esr_bench/reference/hat.py``, written from the paper and the
released code) at a toy size, f32, 1e-5 (the two sum the same products in
the same order but for the CEM's and the GEMMs' blocking); the released
keys; a mirror of the kernel's index arithmetic (the rolled query window,
the overlapping key window with its zero padding, the bias table's rows)
against roll + partition, ``nn.Unfold`` and the released index; the CAB's
weight images; test.py and a served bucket. Neither side imports JAX.

Card (skip without one; run as ``tests/torch_card.py`` says): the attention
kernel against its plain version at B2 x 352 x 512 (HAB at shifts 0 and 8,
OCAB), the masked-edge-keys fault outside its band; the CAB's convs
against ``F.conv2d``; the channel attention against its plain version;
HAT's eval forward as a CUDA graph on the kernels, at B1 and at the
``hat_eval_div2k_b4`` cell's shape. Their times are the cell's.
"""

import json

import pytest
import torch
import torch.nn.functional as F

from esr_bench.reference import hat as ref_hat
from esr_bench.reference.cem import Cem
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.models import make_eval_forward
from esr_tpu_torch.models.networks import define_G, normalize_swinir_keys
from esr_tpu_torch.ops.cuda import channel_attn, hat_attn, kpack_conv, layernorm, token_linear, window_attn
from torch_card import REPO, cuda  # noqa: F401

TOY = {"scale": 4, "bf16": False, "network_G": {
    "which_model_G": "HAT", "upscale": 4, "in_chans": 3, "img_size": 64, "window_size": 4, "compress_ratio": 3,
    "squeeze_factor": 4, "conv_scale": 0.01, "overlap_ratio": 0.5, "img_range": 1.0, "depths": [2, 2],
    "embed_dim": 12, "num_heads": [2, 2], "mlp_ratio": 2, "upsampler": "pixelshuffle", "resi_connection": "1conv"}}
FULL = {"scale": 4, "bf16": True, "network_G": dict(TOY["network_G"], window_size=16, squeeze_factor=30,
                                                    depths=[6] * 6, embed_dim=180, num_heads=[6] * 6)}


def seeded_state(cfg, seed=0, device="cpu"):
    """Weights as the benchmark draws them (``generator_shapes``' gains), the
    LayerNorm weights 1 + noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for key, (shape, gain) in ref_hat.generator_shapes(cfg).items():
        fan = torch.tensor(shape[1:]).prod().item() if len(shape) > 1 else 0
        std = gain * (2.0 / fan) ** 0.5 if len(shape) > 1 else gain
        t = torch.randn(shape, generator=g, device=device) * std
        out[key] = t + 1.0 if key.endswith(("norm.weight", "norm1.weight", "norm2.weight")) else t
    return out


def test_plain_path_and_cem_match_the_reference():
    """LR 10 x 13 reflect-pads to 12 x 16 at window 4 (key window 6, padding
    1), so both shifts, the shifted windows' mask and the OCAB's zero keys
    occur."""
    sd = seeded_state(TOY)
    g = define_G(TOY, device="cpu")
    g.load_state_dict(sd, strict=True)
    lr = torch.rand(2, 10, 13, 3, generator=torch.Generator().manual_seed(1))
    cem = make_cem(CEMConf(scale=4), device="cpu")
    with torch.no_grad():
        port = cem.project(g(lr), lr)
        mine = Cem(4, "cpu").project(ref_hat.generator(sd, TOY, lr), lr)
    assert port.shape == (2, 40, 52, 3)
    torch.testing.assert_close(port, mine, atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # the eval forward (eager on the CPU) gives the same answer
        torch.testing.assert_close(make_eval_forward(g, cem)(lr), port, atol=0, rtol=0)


def test_each_branch_moves_the_answer():
    """Without the CAB branch, with the OCAB bias read the other way round,
    or at shift 0, the toy's answer moves far beyond the 1e-5 of the match
    above: each mechanism is in the comparison."""
    from esr_tpu_torch.models import blocks

    sd = seeded_state(TOY)
    g = define_G(TOY, device="cpu")
    g.load_state_dict(sd, strict=True)
    lr = torch.rand(1, 10, 13, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = ref_hat.generator(sd, TOY, lr)
        planted = {"channel_attention": lambda cx, u, *a: u,
                   "hab_attention": lambda qkv, t, h, ws, s: hat_attn.hab_attention_reference(qkv, t, h, ws, 0),
                   "oca_attention": lambda qkv, t, h, ws, wse: hat_attn.oca_attention_reference(
                       qkv, t.view(h, ws + wse - 1, ws + wse - 1).flip(1, 2).reshape(h, -1), h, ws, wse)}
        for name, fn in planted.items():
            real = getattr(blocks, name)
            setattr(blocks, name, fn)
            try:
                assert (g(lr) - want).abs().max().item() > 1e-2, name
            finally:
                setattr(blocks, name, real)


def test_released_keys_load_with_the_wrapper_and_buffers_dropped():
    sd = seeded_state(TOY)
    buffers = {"relative_position_index_SA": torch.zeros(16, 16, dtype=torch.long),
               "relative_position_index_OCA": torch.zeros(16, 36, dtype=torch.long)}
    state = normalize_swinir_keys({"params_ema": {**sd, **buffers}, "params": {}})
    assert set(state) == set(sd)
    g = define_G(TOY, device="cpu")
    g.load_state_dict(state, strict=True)
    names = set(g.state_dict())
    assert names == set(sd)
    b = "layers.1.residual_group.blocks.1"
    assert {f"{b}.conv_block.cab.0.weight", f"{b}.conv_block.cab.2.bias", f"{b}.conv_block.cab.3.attention.1.weight",
            f"{b}.conv_block.cab.3.attention.3.bias", f"{b}.attn.relative_position_bias_table", "upsample.2.weight",
            "layers.0.residual_group.overlap_attn.relative_position_bias_table", "conv_before_upsample.0.bias"} <= names


# -- the kernel's index arithmetic (csrc/hat_attn.cu), mirrored ------------------------------------------


def query_pixels(h, w, ws, shift):
    """Window (wy, wx)'s query i is the pixel ((ws wy + i / ws + shift) % h,
    (ws wx + i % ws + shift) % w), as y w + x: (windows, ws^2)."""
    wy, wx = torch.arange(h // ws)[:, None, None], torch.arange(w // ws)[None, :, None]
    i = torch.arange(ws * ws)[None, None, :]
    y = (wy * ws + i // ws + shift) % h
    x = (wx * ws + i % ws + shift) % w
    return (y * w + x).reshape(-1, ws * ws)


def key_pixels(h, w, ws, kw):
    """Window (wy, wx)'s key r is the pixel (ws wy - pad + r / kw, ws wx - pad +
    r % kw), pad = (kw - ws) / 2, or -1 outside the map: (windows, kw^2)."""
    pad = (kw - ws) // 2
    wy, wx = torch.arange(h // ws)[:, None, None], torch.arange(w // ws)[None, :, None]
    r = torch.arange(kw * kw)[None, None, :]
    y, x = wy * ws - pad + r // kw, wx * ws - pad + r % kw
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    return torch.where(inside, y * w + x, -1).reshape(-1, kw * kw)


def bias_rows(ws, kw):
    """The kernel's table row of query i and key j: qterm[i] + kterm[j]."""
    t = ws + kw - 1
    q, k = torch.arange(ws * ws), torch.arange(kw * kw)
    qy, qx, ky, kx = q // ws, q % ws, k // kw, k % kw
    if kw == ws:
        qterm, kterm = qy * t + qx + (ws - 1) * (t + 1), -(ky * t + kx)
    else:
        qterm, kterm = -(qy * t + qx) + (ws - 1) * (t + 1), ky * t + kx
    return qterm[:, None] + kterm[None, :]


@pytest.mark.parametrize("h,w", [(32, 48), (48, 32), (16, 80)])
@pytest.mark.parametrize("shift", [0, 8])
def test_query_window_is_roll_and_partition(h, w, shift):
    pix = torch.arange(h * w).view(1, h, w, 1)
    rolled = torch.roll(pix, (-shift, -shift), (1, 2)) if shift else pix
    part = rolled.view(h // 16, 16, w // 16, 16).permute(0, 2, 1, 3).reshape(-1, 256)
    assert torch.equal(query_pixels(h, w, 16, shift), part)


@pytest.mark.parametrize("h,w", [(32, 48), (48, 32), (16, 80), (64, 16)])
def test_key_window_is_unfold(h, w):
    """The 24 x 24 key windows (stride 16, padding 4) by index arithmetic
    equal ``nn.Unfold`` of the pixel indices (plus one, so that its zero
    padding reads -1) at non-square maps; the toy's window 4 / key window 6
    too."""
    for ws, kw in ((16, 24), (4, 6)):
        pix = (torch.arange(h * w, dtype=torch.float64) + 1).view(1, 1, h, w)
        cols = torch.nn.Unfold(kw, stride=ws, padding=(kw - ws) // 2)(pix)[0].t().long() - 1  # (windows, kw^2)
        assert torch.equal(key_pixels(h, w, ws, kw), cols)
        assert torch.equal(hat_attn.oca_keys(pix.permute(0, 2, 3, 1), ws, kw)[..., 0].long() - 1, cols)


@pytest.mark.parametrize("ws,kw", [(16, 24), (4, 6)])
def test_oca_bias_index_covers_the_table(ws, kw):
    """The OCAB's rows run over all of 0 .. (ws + wse - 1)^2 - 1; the
    kernel's qterm + kterm, the port's ``oca_index`` and the reference's
    ``calculate_rpi_oca`` are the same index."""
    index = hat_attn.oca_index(ws, kw)
    assert sorted(index.unique().tolist()) == list(range((ws + kw - 1) ** 2))
    assert torch.equal(bias_rows(ws, kw), index) and torch.equal(ref_hat.oca_index(ws, kw), index)


def test_hab_bias_rows_are_swins():
    """At key window 16 the kernel's rows are Swin's relative_position_index."""
    table = torch.randn(31 * 31, 1)
    dense = window_attn.relative_bias(table, 16)[0]
    assert torch.equal(table[bias_rows(16, 16), 0], dense)


def test_cab_conv_layouts_pad_cout_60_and_run_gelu():
    """The CAB's first conv (180 -> 60) takes the streamed Cin 129-192 image
    with Cout padded to 64 (zeros in 60-63, whose GELU is 0) and the GELU
    epilogue; the second (60 -> 180) the one-chunk image at Cin 64 (zero
    rows 60-63) and Cout 192; no other layout takes GELU."""
    w1, w2 = torch.randn(3, 3, 180, 60), torch.randn(3, 3, 60, 180)
    kw1 = kpack_conv.conv_kernel_weights(F.pad(w1, (0, 4)), torch.zeros(64), torch.bfloat16, torch.device("cpu"))
    kw2 = kpack_conv.conv_kernel_weights(F.pad(w2, (0, 12, 0, 4)), torch.zeros(192), torch.bfloat16,
                                         torch.device("cpu"))
    assert (kw1.cin_pad, kw1.cout, kw1.cout_pad) == (192, 64, 64) and kpack_conv._fuses_gelu(kw1)
    assert (kw2.cin, kw2.cin_pad, kw2.cout_pad) == (64, 64, 192) and not kpack_conv._fuses_gelu(kw2)
    img = kpack_conv.sw128_rows(kw1.wt.float().reshape(-1, 64, 64)).reshape(3, 9, 64, 64)  # chunk, tap, N, K
    got = img.permute(1, 0, 3, 2).reshape(9, 192, 64)
    assert torch.equal(got, F.pad(w1.bfloat16().float().reshape(9, 180, 60), (0, 4, 0, 12)))
    for w in (torch.randn(3, 3, 180, 128), torch.randn(3, 3, 128, 64)):  # two slices; Cin 128 (not streamed)
        assert not kpack_conv._fuses_gelu(kpack_conv.conv_kernel_weights(w, None, torch.bfloat16, torch.device("cpu")))


def test_channel_attention_plain_is_the_squeeze_excitation():
    """u + scale * cx * sigmoid(W2 relu(W1 mean(cx) + b1) + b2) per image,
    reading the first C of ldc channels, in f32."""
    g = torch.Generator().manual_seed(3)
    cx, u = torch.randn(2, 5, 6, 16, generator=g), torch.randn(2, 5, 6, 12, generator=g)
    w1, b1, w2, b2 = (torch.randn(s, generator=g) for s in ((3, 12), (3,), (12, 3), (12,)))
    got = channel_attn.channel_attention(cx, u, w1, b1, w2, b2, 0.01)
    y = cx[..., :12].permute(0, 3, 1, 2)
    s = torch.sigmoid(F.conv2d(F.relu(F.conv2d(F.adaptive_avg_pool2d(y, 1), w1[..., None, None], b1)),
                               w2[..., None, None], b2))
    torch.testing.assert_close(got, u + 0.01 * (y * s).permute(0, 2, 3, 1), atol=1e-6, rtol=1e-6)


def _hat_opt(tmp_path, **extra):
    """The shipped test options (``options/test/test_HAT_SRx4.json``) at the toy widths, f32, on a SYNTHETIC
    set of two images."""
    from pathlib import Path

    import esr_tpu_torch

    opt = json.loads((Path(esr_tpu_torch.__file__).parent / "options/test/test_HAT_SRx4.json").read_text())
    assert opt["network_G"] == FULL["network_G"]
    opt.update(bf16=False, watchdog=False)
    opt["network_G"] = dict(TOY["network_G"])
    opt["path"] = {"root": str(tmp_path), "pretrain_model_G": extra.get("pth")}
    opt["datasets"] = {"test_1": {"name": "syn", "mode": "SYNTHETIC", "n_images": 2, "image_size": 52}}
    path = tmp_path / "opt.json"
    path.write_text(json.dumps(opt))
    return path


def test_eval_cli_runs_the_hat_options(tmp_path):
    """test.py with the HAT options (toy widths, a released-style
    ``params_ema`` file with HAT's index buffers as its weights): the CEM
    keeps every answer consistent with its LR."""
    from esr_tpu_torch import test as test_cli

    pth = tmp_path / "G.pth"
    torch.save({"params_ema": {**seeded_state(TOY), "relative_position_index_SA": torch.zeros(1)}}, pth)
    out = test_cli.main(["-opt", str(_hat_opt(tmp_path, pth=str(pth))), "--device", "cpu"])
    assert out["syn"]["cem_residual"] < 1e-4 and out["syn"]["psnr"] > 0


def test_exported_hat_serves_one_bucket(tmp_path):
    """An exported toy HAT answers an LR of its bucket as the live eval forward does."""
    from esr_tpu_torch.export import export_servable, load_servable
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    model = create_model(parse(str(_hat_opt(tmp_path)), is_train=False), device="cpu")
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


def _attention_case(cuda, n, seed, oca):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(n, 352, 512, 540, device=cuda, generator=g).bfloat16()
    table = torch.randn(6, (39 if oca else 31) ** 2, device=cuda, generator=g)
    return qkv, table


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hab0", "hab8", "oca"])
def test_cuda_hat_attention_matches_plain(cuda, mode):
    """B2 x 352 x 512, 6 heads of 30: the HAB's window-16 attention at shift
    0 and 8 and the OCAB's 256 x 576: one launch counted on its counter,
    within twice the bf16 plain version's own error against the f32 plain
    version on the same bf16 qkv (the kernel rounds P to bf16 for P V and
    its output to bf16, as the plain bf16 version does; its sums run in
    another order and its softmax in base 2), and that error under 2% of the
    output's largest value."""
    oca = mode == "oca"
    qkv, table = _attention_case(cuda, 2, 11 + len(mode), oca)
    counter = hat_attn.LAUNCHES_OCA if oca else hat_attn.LAUNCHES_HAB
    before = counter.count
    with torch.no_grad():
        if oca:
            got = hat_attn.oca_attention(qkv, table, 6, 16, 24)
            want = hat_attn.oca_attention_reference(qkv.float(), table, 6, 16, 24)
            bf = hat_attn.oca_attention_reference(qkv, table, 6, 16, 24)
        else:
            shift = int(mode[3:])
            got = hat_attn.hab_attention(qkv, table, 6, 16, shift)
            want = hat_attn.hab_attention_reference(qkv.float(), table, 6, 16, shift)
            bf = hat_attn.hab_attention_reference(qkv, table, 6, 16, shift)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    own = (bf.float() - want).abs().max().item()
    err = (got.float() - want).abs().max().item()
    assert got.shape == (2, 352, 512, 180) and err <= 2 * own and err <= 0.02 * want.abs().max().item(), (err, own)


@pytest.mark.cuda
def test_cuda_oca_scores_the_edge_keys_at_their_bias(cuda):
    """The OCAB kernel scores keys outside the map at their bias alone: with
    q = 0 (every score its bias) and v near 1, a query's output is about the
    weight its in-map keys carry, so the plain version with the outside keys
    masked instead (weights renormalised over the in-map keys, output near
    1) differs from the kernel in the edge windows by far more than the
    rounding band, and agrees in the inner windows."""
    from esr_bench.traffic.hat import faulty_oca

    qkv, table = _attention_case(cuda, 1, 5, True)
    qkv[..., :180] = 0
    qkv[..., 360:] = (1 + 0.1 * qkv[..., 360:].float()).bfloat16()
    with torch.no_grad():
        got = hat_attn.oca_attention(qkv, table, 6, 16, 24).float()
        want = hat_attn.oca_attention_reference(qkv.float(), table, 6, 16, 24)
        masked = faulty_oca("oca_edge_masked")(qkv.float(), table, 6, 16, 24)
    band = 2 * (hat_attn.oca_attention_reference(qkv, table, 6, 16, 24).float() - want).abs().max().item()
    assert (got - want).abs().max().item() <= band
    edge = (got - masked)[:, :16].abs().max().item()  # the first window row: keys above the map
    inner = (got - masked)[:, 16:-16, 16:-16].abs().max().item()
    assert edge > 10 * band and inner <= band, (edge, inner, band)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (4, 352, 512)], ids=["ragged", "cell"])
def test_cuda_cab_convs_on_tensor_cores(cuda, shape):
    """The CAB's 180 -> 60 (Cout padded to 64) with GELU on
    ``conv_tc_kernel_gelu`` and 60 -> 180 (Cin 64, Cout 192) on
    ``conv_tc_kernel``, one launch each, within twice the bf16 plain
    version's error against the f32 ``F.conv2d`` on the same bf16 inputs
    (the conv band), the padded channels zero."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(*shape, 180, device=cuda, generator=g).bfloat16()
    w1 = torch.randn(3, 3, 180, 60, device=cuda, generator=g) * (2.0 / (9 * 180)) ** 0.5
    w2 = torch.randn(3, 3, 60, 180, device=cuda, generator=g) * (2.0 / (9 * 60)) ** 0.5
    b1, b2 = 0.1 * torch.randn(60, device=cuda, generator=g), 0.1 * torch.randn(180, device=cuda, generator=g)
    kw1 = kpack_conv.conv_kernel_weights(F.pad(w1, (0, 4)), F.pad(b1, (0, 4)), torch.bfloat16, cuda)
    kw2 = kpack_conv.conv_kernel_weights(F.pad(w2, (0, 12, 0, 4)), F.pad(b2, (0, 12)), torch.bfloat16, cuda)
    before = kpack_conv.LAUNCHES.count
    with torch.no_grad():
        y1 = kpack_conv.conv_launch(x, kw1, False, gelu=True)
        y2 = kpack_conv.conv_launch(y1, kw2, False)
    torch.cuda.synchronize()
    assert kpack_conv.LAUNCHES.count == before + 2 and y1.shape[-1] == 64 and y2.shape[-1] == 192
    assert not y1[..., 60:].any() and not y2[..., 180:].any()
    for got, xin, w, b, gelu in ((y1[..., :60], x, w1, b1, True), (y2[..., :180], y1[..., :60], w2, b2, False)):
        want = kpack_conv.conv3x3_reference(xin.float(), w, b, gelu=gelu)
        own = (kpack_conv.conv3x3_reference(xin, w, b, gelu=gelu).float() - want).abs().max().item()
        tol = max(2 * own, 2.0**-6 * want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 48, 80), (4, 352, 512)], ids=["b1", "cell"])
def test_cuda_channel_attention_matches_plain(cuda, shape):
    """The pool (its last block squeezing) and the scale pass, twice (the
    per-image counters start at zero each launch), against the f32 plain
    version on the same bf16 maps: within one bf16 step of the residual
    (the kernel rounds once, from f32), and the channel attention's scale
    is there (dropping the sigmoid moves the answer far more)."""
    g = torch.Generator(device=cuda).manual_seed(shape[0])
    cx = (10 * torch.randn(*shape, 192, device=cuda, generator=g)).bfloat16()
    u = torch.randn(*shape, 180, device=cuda, generator=g).bfloat16()
    w1, b1 = 0.2 * torch.randn(6, 180, device=cuda, generator=g), 0.01 * torch.randn(6, device=cuda, generator=g)
    w2, b2 = torch.randn(180, 6, device=cuda, generator=g), 0.01 * torch.randn(180, device=cuda, generator=g)
    before = channel_attn.LAUNCHES.count
    with torch.no_grad():
        outs = [channel_attn.channel_attention(cx, u, w1, b1, w2, b2, 0.01) for _ in range(2)]
    torch.cuda.synchronize()
    assert channel_attn.LAUNCHES.count == before + 2 and torch.equal(outs[0], outs[1])
    want = channel_attn.channel_attention_reference(cx.float(), u.float(), w1, b1, w2, b2, 0.01)
    step = 2.0**-8 * want.abs().max().item()
    assert (outs[0].float() - want).abs().max().item() <= step
    dropped = u.float() + 0.01 * cx[..., :180].float()
    assert (dropped - want).abs().max().item() > 10 * step


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed", [((1, 45, 62), 3), ((4, 339, 510), 14)], ids=["b1", "cell"])
def test_cuda_hat_eval_forward_runs_on_the_kernels(cuda, shape, seed):
    """HAT at its published widths and depth behind the CEM, as a CUDA
    graph: a replay launches 36 HAB and 6 OCAB attentions, 36 channel
    attentions, 84 conv3x3 (the CABs' 72 among them), no parity conv, 86
    layernorm, 168 token_linear and no window_attn; the answer within the
    ``hat_eval_div2k_b4`` cell's own limits of the f32 reference (TF32 off),
    at B1 x LR 45 x 62 (padded 48 x 64: every window at the map's edge) and
    at the cell's shape, B4 x LR 339 x 510 (padded 352 x 512)."""
    from esr_bench.traffic.eval import compare

    limits = json.loads((REPO / "esr_bench" / "workloads" / "hat_eval_div2k_b4.json").read_text())["limits"]
    rel_limit, residual_limit = limits["sr_rel_err"], limits["cem_residual"]
    sd = seeded_state(FULL, seed=seed, device=cuda)
    g = define_G(FULL, device=cuda)
    g.load_state_dict(sd, strict=True)
    fwd = make_eval_forward(g, make_cem(CEMConf(scale=4), device=cuda))
    lr = torch.rand(*shape, 3, device=cuda, generator=torch.Generator(device=cuda).manual_seed(seed))
    fwd(lr)
    counters = (hat_attn.LAUNCHES_HAB, hat_attn.LAUNCHES_OCA, channel_attn.LAUNCHES, kpack_conv.LAUNCHES,
                kpack_conv.LAUNCHES_UP, layernorm.LAUNCHES, token_linear.LAUNCHES, window_attn.LAUNCHES)
    before = [c.count for c in counters]
    out = fwd(lr)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [36, 6, 36, 84, 0, 86, 168, 0]
    cem = Cem(4, cuda)
    with torch.no_grad():
        want = cem.project(ref_hat.generator(sd, FULL, lr), lr)
    rel, residual = compare(cem, out, want, lr)
    assert out.shape == want.shape and max(rel) < rel_limit and residual < residual_limit, (max(rel), residual)
