"""Blind SR and the generator variants on the card.

CEM's fft and filter modes under 2-D kernels with cuDNN's TF32 at torch's
default (on); KernelGAN: the effective-kernel identity, the supervised probe
(corr > 0.88, the same kernel bit for bit twice), the adversarial estimate
through ``scripts.blind_bench`` (LR 96, 2000 iterations), the iteration as a
CUDA graph against the eager loop bit for bit; the ``estimate_kernel``
script; blind eval (``test.main --estimate_kernel``) at the flagship width
on two 1/f images and their Gaussian LR, and the explorer's session with an
estimated kernel; ``latent_input='all_layers'`` and SRResNet nf 64 nb 16 at
full width: forwards, G's gradient band, their trainers, and SRResNet's 64
-> 256 upconvs on the tensor-core kernel no slower than ``F.conv2d``.
"""

import contextlib
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esr_tpu_torch.cem import CEMConf, kernelgan, make_cem
from esr_tpu_torch.cem.kernels import downsample_kernel_2d, resolve_kernel
from esr_tpu_torch.data.util import read_img, save_img
from esr_tpu_torch.device import full_f32
from esr_tpu_torch.explore import cli as explore_cli
from esr_tpu_torch.models import create_model, define_G
from esr_tpu_torch.ops import tensor2img
from esr_tpu_torch.ops.cuda import kpack_conv
from esr_tpu_torch.ops.cuda.conv_bench import launch_ms
from esr_tpu_torch.ops.cuda.kpack_conv import conv3x3_reference, conv_launch
from esr_tpu_torch.options import parse
from esr_tpu_torch.scripts import blind_bench
from esr_tpu_torch.utils.graphs import GraphedStep
from torch_card import (B, CEM_TOL, EXPECTED_PER_FORWARD, F32_KERNEL_LAUNCHES, LAYOUT_COUNTERS, LR, NB, NF, NZ,  # noqa: F401
                        SCALE, SearchLog, card, check_variant_forward, conv_band, counted, cuda, fixed_batch,
                        flagship_options, g0_pth, grad_band, grad_paths, hr_batches, max_err, per_forward, run_cli,
                        run_train, train_csv, train_options)

BLIND_LR = 96  # blind_bench's larger LR: 1/f HR 384 images, their Gaussian LR
BLIND_ITERS = 200  # the estimator iterations of the blind CLIs' runs
BENCH_ITERS = 2000  # blind_bench's adversarial estimate
K_TRUE = blind_bench.gaussian_kernel()


def kernel_tuple(k) -> tuple:
    return tuple(map(tuple, np.asarray(k, np.float64)))


def cem_tol(kernel) -> float:
    """The CEM residual's f32 limit under ``kernel``: the rounding of a
    correlation grows with sum |k|, 1 for a nonnegative unit-sum kernel and
    ~11 for a sign-mixed 200-iteration estimate."""
    return CEM_TOL * max(1.0, float(np.abs(np.asarray(kernel, np.float64)).sum()))


def blind_lr(seed: int, k_true) -> tuple[np.ndarray, np.ndarray]:
    """A 1/f HR 384 image and its LR 96 under the true kernel (H on the card)."""
    hr = blind_bench.one_f_image(BLIND_LR * SCALE, BLIND_LR * SCALE, seed)
    cem = make_cem(CEMConf(scale=SCALE, kernel=kernel_tuple(k_true)), device="cuda")
    with torch.no_grad():
        lr = cem.downsample(torch.from_numpy(hr)[None].cuda()).clamp(0.0, 1.0)[0].cpu().numpy()
    return hr, lr


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 40, 48), (4, 128, 128)])
@pytest.mark.parametrize("mode", ["fft", "filter"])
@pytest.mark.parametrize("kernel", ["aniso_gauss", "bicubic_2d"])
def test_cuda_cem_nonseparable_modes_with_tf32_default(cuda, kernel, mode, shape):
    """CEM's fft and filter modes under a 2-D kernel (the anisotropic
    Gaussian 13 x 13, MATLAB's bicubic 16 x 16) on the card with cuDNN's TF32
    at torch's default (on): H equals the f64 CPU H to 1e-5 (TF32 is off
    inside CEM's convs), the projection is consistent (fft within CEM_TOL;
    filter at support 33, below 2e-3) and, in fft mode, H and its transpose
    are adjoint in f64 (<Hx, y> - <x, H^T y> within 1e-9 of <Hx, y>)."""
    k = blind_bench.gaussian_kernel() if kernel == "aniso_gauss" else downsample_kernel_2d(4)[0]
    conf = CEMConf(scale=4, kernel=kernel_tuple(k), inv_mode=mode, inv_filter_support=33)
    g = torch.Generator(device=cuda).manual_seed(11)
    n, h, w = shape
    raw = torch.rand(n, 4 * h, 4 * w, 3, device=cuda, generator=g) * 3 - 1
    lr = torch.rand(n, h, w, 3, device=cuda, generator=g)
    torch.backends.cudnn.allow_tf32 = True
    try:
        cem = make_cem(conf, device=cuda)
        with torch.no_grad():
            res = max_err(cem.downsample(cem.project(raw, lr)), lr)
            hx = cem.downsample(raw[:1]).double().cpu()
            x, y = raw[:1].double(), lr[:1].double()
            a, b = float((cem.downsample(x) * y).sum()), float((x * cem.upsample_transpose(y, x.shape)).sum())
        assert torch.backends.cudnn.allow_tf32  # CEM restores the caller's setting
    finally:
        torch.backends.cudnn.allow_tf32 = False
    h64 = make_cem(conf, device="cpu").downsample(raw[:1].double().cpu())
    assert cem._mode == mode and (hx - h64).abs().max().item() <= 1e-5
    if mode == "fft":
        assert res <= CEM_TOL and abs(a - b) <= 1e-9 * abs(a), (res, a, b)
    else:
        assert res < 2e-3, res


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_cem_bicubic_fft_equals_matmul(cuda):
    """Under the default bicubic kernel the fft mode's project and H^+ equal
    the matmul mode's to 2e-4 (B4 x LR 128)."""
    g = torch.Generator(device=cuda).manual_seed(40)
    raw = torch.rand(4, 4 * LR, 4 * LR, 3, device=cuda, generator=g) * 3 - 1
    lr = torch.rand(4, LR, LR, 3, device=cuda, generator=g)
    cem_m = make_cem(CEMConf(scale=SCALE), device=cuda)
    cem_f = make_cem(CEMConf(scale=SCALE, inv_mode="fft"), device=cuda)
    assert max(max_err(cem_m.project(raw, lr), cem_f.project(raw, lr)),
               max_err(cem_m.dt_satisfying_upscale(lr), cem_f.dt_satisfying_upscale(lr))) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["tf32_default", "full_f32"])
def test_cuda_kernelgan_effective_kernel_is_exact(cuda, precision):
    """KernelGAN's linear G on the card, cuDNN's TF32 at torch's default and
    under ``full_f32``: its stride-1 output is one VALID correlation with its
    effective kernel (21 x 21) to 1e-5, and the strided output its ::4
    subsample bit for bit."""
    conf = kernelgan.KernelGANConf()
    g = kernelgan.LinearKernelG(conf, seed=3).to(cuda)
    x = torch.rand(1, BLIND_LR, BLIND_LR, 1, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    torch.backends.cudnn.allow_tf32 = precision == "tf32_default"
    try:
        with torch.no_grad(), full_f32() if precision == "full_f32" else contextlib.nullcontext():
            k = kernelgan.effective_kernel(g, conf)
            flat = g(x, stride=False)
            strided = g(x)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        want = F.conv2d(x.permute(0, 3, 1, 2), k[None, None]).permute(0, 2, 3, 1)
    assert tuple(k.shape) == (21, 21) and max_err(flat, want) <= 1e-5
    assert torch.equal(strided, flat[:, ::4, ::4])


# the supervised probe: tests/test_kernelgan.py's conf, and its loss, a
# centred SAME conv with the true kernel on G's phase
PROBE = kernelgan.KernelGANConf(scale=4, g_kernels=(7, 5, 3, 1), g_channels=16, d_kernels=(5, 1, 1), d_channels=16,
                                g_input=32, iters=1000, lr_g=2e-3, w_centralized=0.1, w_boundaries=0.1)


def probe_loss(device):
    """The probe's loss, its kernel uploaded now (nothing captured in a CUDA
    graph may copy from the host)."""
    kt = torch.tensor(K_TRUE, dtype=torch.float32, device=device)[None, None]

    def loss(fake, g_in):
        full = F.conv2d(g_in.permute(0, 3, 1, 2), kt, padding=6).permute(0, 2, 3, 1)
        return torch.mean((fake - full[:, 6::4, 6::4][:, : fake.shape[1], : fake.shape[2]]) ** 2)

    return loss


PROBE_IMAGE = np.random.default_rng(2).random((96, 96)).astype(np.float32)


@pytest.mark.cuda
def test_cuda_kernelgan_supervised_probe(cuda):
    """1000 iterations, cuDNN deterministic (``make_override_step``): aligned
    corr with the true kernel above 0.88, unit sum; a second run gives the
    same kernel bit for bit."""
    loss = probe_loss(cuda)
    k_est, _ = kernelgan.estimate_kernel(PROBE_IMAGE, PROBE, loss_override=loss, device=cuda)
    k_again, _ = kernelgan.estimate_kernel(PROBE_IMAGE, PROBE, loss_override=loss, device=cuda)
    assert blind_bench.aligned_corr(k_est, K_TRUE) > 0.88 and abs(k_est.sum() - 1) < 1e-6
    assert np.array_equal(k_est, k_again)


@pytest.mark.cuda
def test_cuda_blind_bench_adversarial_estimate(cuda):
    """``blind_bench.run_case`` (aniso Gaussian, LR 96, 2000 iterations; G nf
    16 / nb 2 / gc 8 in f32, the f32 route): every PSNR and true-operator
    residual finite, the true kernel's self and true-operator residuals and
    bicubic's self residual within CEM_TOL, launches on every f32 counter."""
    row, launches = counted(lambda: blind_bench.run_case("aniso_gauss", K_TRUE, BLIND_LR, BENCH_ITERS, seed=0,
                                                         device=cuda), tuple(F32_KERNEL_LAUNCHES) + (kpack_conv.LAUNCHES_F32,))
    assert all(math.isfinite(row[f"{p}_{lab}"]) for p in ("psnr", "true_res") for lab in ("est", "true", "bicubic"))
    assert row["self_res_true"] <= CEM_TOL and row["self_res_bicubic"] <= CEM_TOL and row["true_res_true"] <= CEM_TOL
    assert all(launches.values()), launches


def _loss(fake, g_in):
    return F.mse_loss(fake, 0.5 * g_in[:, 10::4, 10::4][:, : fake.shape[1], : fake.shape[2]])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["adversarial", "override", "adversarial-lr96", "probe"])
def test_cuda_kernelgan_graph_equals_eager(cuda, case):
    """KernelGAN's iterations with each iteration a replay of one CUDA graph
    against the same loop eagerly, cuDNN deterministic: the kernel and the
    metrics of every chunk of 100 bit for bit. 150 iterations (chunks of 100
    and 50) of the default conf on a random image, adversarial or with a
    loss override; 250 (100, 100, 50) of the adversarial conf of the blind
    LR 96 image and of the supervised probe."""
    if case in ("adversarial", "override"):
        img, conf, loss, ends = np.random.default_rng(3).random((72, 80)).astype(np.float32), \
            kernelgan.KernelGANConf(iters=150), _loss if case == "override" else None, [100, 150]
    elif case == "adversarial-lr96":
        img = blind_lr(0, K_TRUE)[1]
        conf, loss, ends = kernelgan.conf_for_image(img.shape, SCALE, 250), None, [100, 200, 250]
    else:
        img, conf, loss, ends = PROBE_IMAGE, kernelgan.KernelGANConf(**{**PROBE.__dict__, "iters": 250}), probe_loss(cuda), \
            [100, 200, 250]
    init = GraphedStep.__init__

    def eager_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.enabled = False

    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for graphed in (True, False):
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                if not graphed:  # the same loop, every iteration eagerly
                    mp.setattr(GraphedStep, "__init__", eager_init)
                k, m = kernelgan.estimate_kernel(img, conf, progress=lambda *a: calls.append(a),  # noqa: B023
                                                 loss_override=loss, device=cuda)
            runs.append((k, m, calls))
        (kg_, mg, cg), (ke, me, ce) = runs
        assert np.array_equal(kg_, ke) and mg == me and cg == ce and [c[0] for c in cg] == ends
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.fixture(scope="module")
def blind_png(tmp_path_factory):
    """The blind LR 96 image (seed 0), written as a PNG."""
    card()
    path = tmp_path_factory.mktemp("blind") / "blind_lr.png"
    save_img(tensor2img(blind_lr(0, K_TRUE)[1]), str(path))
    return path


@pytest.mark.cuda
def test_cuda_estimate_kernel_cli(blind_png):
    """``scripts.estimate_kernel`` at 200 iterations on the LR 96 PNG: a
    unit-sum 21 x 21 .npy that ``resolve_kernel`` loads."""
    from esr_tpu_torch.scripts import estimate_kernel as estimate_kernel_cli

    out = blind_png.parent / "kernel_x4.npy"
    estimate_kernel_cli.main(["--lr", str(blind_png), "--iters", str(BLIND_ITERS), "--out", str(out),
                              "--watchdog", "0", "--device", "cuda"])
    k = np.load(out)
    assert k.shape == (21, 21) and abs(k.sum() - 1) < 1e-6 and np.asarray(resolve_kernel(str(out))).shape == (21, 21)


@pytest.fixture(scope="module")
def blind_evals(g0_pth, tmp_path_factory):
    """Blind eval through ``test.main`` at the flagship width on an LRHR
    folder (two 1/f HR 384 images, their Gaussian LR): with
    ``--estimate_kernel 200`` and without; and, as tests/test_torch_blind.py
    checks the wiring, with G's output zeroed (SR = the CEM low-frequency
    term, so no clipping hides the operator) and the estimator returning the
    true kernel, against the same G without the flag. Each run: its metrics,
    launches, the SR's true-operator residual and the kernel it ran under."""
    tmp = tmp_path_factory.mktemp("blind_eval")
    hr_dir, lr_dir = tmp / "blind_hr", tmp / "blind_lr"
    for i in range(2):
        hr, lr = blind_lr(10 + i, K_TRUE)
        save_img(tensor2img(hr), str(hr_dir / f"img{i}.png"))
        save_img(tensor2img(lr), str(lr_dir / f"img{i}.png"))
    zero_pth = str(tmp / "G_zero_out.pth")
    sd = torch.load(g0_pth)
    torch.save({k: torch.zeros_like(v) if k.startswith("conv_last.") else v for k, v in sd.items()}, zero_pth)
    cem_true = make_cem(CEMConf(scale=SCALE, kernel=kernel_tuple(K_TRUE)), device="cuda")
    ds = {"test_1": {"name": "blind", "mode": "LRHR", "dataroot_HR": str(hr_dir), "dataroot_LR": str(lr_dir)}}
    est = ["--estimate_kernel", str(BLIND_ITERS)]
    runs = {}
    orig = kernelgan.estimate_kernel
    for label, g_path, flags in (("estimated", g0_pth, est), ("no flag", g0_pth, []),
                                 ("true kernel, G zeroed", zero_pth, est), ("no flag, G zeroed", zero_pth, [])):
        opt = flagship_options(tmp, g_path, "blind_" + label.replace(" ", "_").replace(",", ""), ds, num_random_Z=0)
        used = [None]

        def estimate(*a, label=label, used=used, **kw):  # records the kernel the model is built under
            k, m = (K_TRUE.copy(), {"l_g": 0.0}) if label.startswith("true kernel") else orig(*a, **kw)
            used[0] = k
            return k, m

        kernelgan.estimate_kernel = estimate
        try:
            res, launches = run_cli(tmp, opt, "--save_images", "--device", "cuda", *flags)
        finally:
            kernelgan.estimate_kernel = orig
        worst = 0.0
        for f in sorted(lr_dir.iterdir()):
            sr = torch.from_numpy(read_img(str(tmp / "results" / opt["name"] / "blind" / f.name)))[None].cuda()
            lr = torch.from_numpy(read_img(str(f)))[None].cuda()
            worst = max(worst, max_err(cem_true.downsample(sr), lr))
        runs[label] = {"metrics": res["blind"], "launches": launches, "true_res": worst, "kernel": used[0]}
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["estimated", "no flag", "true kernel, G zeroed", "no flag, G zeroed"])
def test_cuda_blind_eval(blind_evals, label):
    """2 forwards of 69 / 4 / 2 launches; the CEM residual under the kernel
    the model ran under within ``cem_tol`` of it (CEM_TOL x sum |k|)."""
    run = blind_evals[label]
    assert run["launches"] == per_forward(2)
    assert run["metrics"]["cem_residual"] <= cem_tol(1.0 if run["kernel"] is None else run["kernel"])


@pytest.mark.cuda
def test_cuda_blind_eval_runs_under_the_estimated_kernel(blind_evals):
    """G zeroed and the estimator returning the true kernel: the SR's
    true-operator residual below 5e-3, and the bicubic assumption's more than
    10x that."""
    t_true, t_off = blind_evals["true kernel, G zeroed"]["true_res"], blind_evals["no flag, G zeroed"]["true_res"]
    assert t_true < 5e-3 and t_off > 10 * t_true, (t_true, t_off)


@pytest.mark.cuda
def test_cuda_blind_explore(g0_pth, blind_png):
    """The explorer's session with ``estimate_kernel_iters`` 200 on the LR 96
    PNG: CEM in fft mode under the estimate; one 64-step smooth click's loss
    goes down, the CEM residual within ``cem_tol`` of the estimate, undo
    restores the SR bit for bit, no layout built, 69 / 4 / 2 launches a G
    call."""
    tmp = blind_png.parent
    opt_path = tmp / "blind_explore.json"
    opt_path.write_text(json.dumps(flagship_options(tmp, g0_pth, "blind_explore", {})))
    sess = explore_cli.build_session_from_opt(str(opt_path), str(blind_png), estimate_kernel_iters=BLIND_ITERS,
                                              device="cuda")
    log = SearchLog(sess._optimizer)
    sess._optimizer = log
    forwards = [0]
    hook = log.hook(sess.g, forwards)
    sess.select_rect(28 * SCALE, 28 * SCALE, 68 * SCALE, 68 * SCALE)
    lr = torch.from_numpy(sess.lr_img).cuda()
    sr_before = sess.current_sr().copy()
    builds0 = [c.count for c in LAYOUT_COUNTERS]
    forwards[0] = 0
    _, launches = counted(sess.smooth)
    hook.remove()
    trace = log.traces[-1]
    res = max_err(sess.cem.downsample(torch.from_numpy(sess.current_sr()).cuda()), lr)
    sess.undo()
    assert sess.cem._mode == "fft" and trace[-1] < trace[0]
    assert res <= cem_tol(sess.cem.conf.kernel) and np.array_equal(sess.current_sr(), sr_before)
    assert [c.count - b for c, b in zip(LAYOUT_COUNTERS, builds0)] == [0, 0]
    assert launches == per_forward(forwards[0] + len(trace))


# -- the generator variants at full width ------------------------------------------


@pytest.fixture(scope="module")
def all_layers_pth(tmp_path_factory):
    """The flagship with Z re-injected before every RRDB (``latent_input``
    ``all_layers``), seed 0. The reference init (Kaiming, gain sqrt 2) of the
    23 unactivated 1x1 projections grows the trunk ~3000x; at unit gain the
    outputs stay images, and PSNR and the GAN losses mean something."""
    card()
    net = {"nf": NF, "nb": NB, "gc": 32, "num_latent_channels": NZ, "latent_input": "all_layers"}
    g = define_G({"network_G": net, "scale": SCALE, "bf16": True}, device="cuda", seed=0)
    with torch.no_grad():
        for proj in g.latent_proj:
            proj.weight.mul_(2**-0.5)
    path = tmp_path_factory.mktemp("all_layers") / "G_all_layers.pth"
    torch.save(g.state_dict(), path)
    return path


@pytest.mark.cuda
def test_cuda_all_layers_forward(all_layers_pth):
    """B16 x LR 128: 69 / 4 / 2 launches, PSNR within the band, CEM residual."""
    net = {"nf": NF, "nb": NB, "gc": 32, "num_latent_channels": NZ, "latent_input": "all_layers"}
    g = define_G({"network_G": net, "scale": SCALE, "bf16": True}, device="cuda")
    g.load_state_dict(torch.load(all_layers_pth))
    check_variant_forward(g, EXPECTED_PER_FORWARD)


@pytest.fixture(scope="module")
def all_layers_trainer(all_layers_pth):
    opt = train_options(all_layers_pth.parent, "train_all_layers", "train_explorable_SR.json", None, niter=2)
    opt["network_G"]["latent_input"] = "all_layers"
    opt["path"]["pretrain_model_G"] = str(all_layers_pth)
    return create_model(parse(opt, is_train=True), device="cuda")


@pytest.mark.cuda
def test_cuda_all_layers_gan_step_gradient_band(all_layers_trainer):
    """One GAN step's G gradients on a fixed B16 x HR 128 batch through the
    kernels against the f32 plain path within twice the bf16 plain path's
    relative L2 (at least a bf16 half-ulp); 69 / 4 / 2 launches; l_g finite."""
    model = all_layers_trainer
    paths = grad_paths(model, fixed_batch("cuda"))
    worst, _, _ = grad_band([n for n, _ in model.g_module.named_parameters()], paths["kernels"][1],
                            paths["bf16 plain"][1], paths["f32 plain"][1])
    assert worst <= 1.0 and paths["launches"] == EXPECTED_PER_FORWARD
    assert math.isfinite(float(paths["kernels"][0]["l_g"]))


@pytest.mark.cuda
def test_cuda_all_layers_gan_trainer(all_layers_trainer):
    """Two GAN steps at B16 x HR 128: 2 x 69 / 4 / 2 launches, finite losses."""
    model = all_layers_trainer
    model.feed_data(hr_batches(1)[0])

    def two_steps():
        for s in (1, 2):
            model.optimize_parameters(s)
        return model.get_current_losses()

    losses, launches = counted(two_steps)
    assert launches == per_forward(2) and all(math.isfinite(v) for v in losses.values())


SRRESNET = {"which_model_G": "sr_resnet", "nf": NF, "nb": 16, "num_latent_channels": NZ}
SRRESNET_PER_FORWARD = {"rdb5c": 0, "conv3x3": 38, "upsample2x_conv3x3": 0}


@pytest.fixture(scope="module")
def srresnet():
    """SRResNet nf 64, nb 16, x4 in bf16, seed 0: 38 tensor-core convs a
    forward (its two 64 -> 256 upconvs in four Cout slices each)."""
    card()
    return define_G({"network_G": SRRESNET, "scale": SCALE, "bf16": True}, device="cuda", seed=0)


@pytest.mark.cuda
def test_cuda_srresnet_forward(srresnet):
    check_variant_forward(srresnet, SRRESNET_PER_FORWARD)


@pytest.mark.cuda
@pytest.mark.parametrize("i", [1, 2])
@torch.no_grad()
def test_cuda_srresnet_upconv_no_slower_than_the_library(srresnet, i):
    """SRResNet's 64 -> 256 ``upconv``s at their forward shapes (B16 x 128^2
    and 256^2) with the layouts the forward uses: on the tensor-core kernel
    (one launch counted on the 3x3 counter, none elsewhere) within the bf16
    conv band of the f32 plain version on the same bf16 inputs, and no slower
    than ``F.conv2d`` on the channels-last input, CUDA events."""
    srresnet.prepare_kernels()
    m = getattr(srresnet, f"upconv{i}")
    s = LR * i
    x = torch.randn(B, s, s, NF, device="cuda", generator=torch.Generator("cuda").manual_seed(i)).bfloat16()
    w, bias, kw = m.hwio(), m.bias, m.kernel_weights
    ref = conv3x3_reference(x.float(), w, bias, True)
    tol = conv_band(ref, max_err(conv3x3_reference(x, w, bias, True), ref))
    counters = (kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP, *F32_KERNEL_LAUNCHES, kpack_conv.LAUNCHES_F32)
    before = [c.count for c in counters]
    got = conv_launch(x, kw, True)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [1, 0, 0, 0, 0, 0] and kw.route == "tc"
    assert got.shape == ref.shape and max_err(got, ref) <= tol
    del ref, got
    xc, wb, bb = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).bfloat16(), bias.bfloat16()
    kernel_ms = launch_ms(lambda: conv_launch(x, kw, True), reps=10)
    assert kernel_ms <= launch_ms(lambda: F.conv2d(xc, wb, bb, padding=1), reps=10)


@pytest.mark.cuda
def test_cuda_srresnet_sr_trainer(cuda, tmp_path):
    """The SR trainer (train_RRDB_PSNR.json) on SRResNet, 2 steps: 2 x 0 / 38
    / 0 launches, finite l_pix."""
    opt = train_options(tmp_path, "train_srresnet", "train_RRDB_PSNR.json", None, niter=2)
    opt["network_G"] = dict(SRRESNET, num_latent_channels=0)
    _, launches = run_train(tmp_path, opt, "--device", "cuda")
    rows = train_csv(tmp_path, "train_srresnet")
    assert launches == per_forward(2, SRRESNET_PER_FORWARD) and len(rows) == 2
    assert all(math.isfinite(float(r["l_pix"])) for r in rows)
