"""Blind SR in the port, wired end to end on the CPU, against the JAX
package where it has a counterpart:

- the eval CLI's ``--estimate_kernel`` (the port of
  tests/test_e2e.py::test_blind_eval_flag_restores_true_consistency): the
  estimator stubbed to the true kernel in both packages, a zeroed G (SR ==
  the CEM low-frequency term), a dataset degraded by the anisotropic
  Gaussian. The blind SR PNGs are consistent with the true operator to
  5e-3 (the uint8 floor), the bicubic assumption's more than 10x that, and
  the port's PNGs equal ``esr_tpu.test``'s within 1 uint8 level;
- the explore CLI's ``--estimate_kernel``: the session's CEM is the fft
  mode of the kernel the estimator returns for that LR, and consistent under
  it;
- ``scripts.estimate_kernel`` writes a unit-sum 2-D ``.npy`` that
  ``resolve_kernel`` loads; ``scripts.blind_bench`` runs and keeps the JAX
  script's image, kernel and correlation;
- an artifact exported under a 2-D kernel rebuilds the fft CEM and serves
  what the live forward computes.
"""

import json

import numpy as np
import pytest
import torch

from esr_tpu.scripts import blind_bench as jbench
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.cem import kernelgan
from esr_tpu_torch.cem.kernels import resolve_kernel
from esr_tpu_torch.data.util import read_img, read_img_uint8, save_img
from esr_tpu_torch.ops.color import tensor2img
from esr_tpu_torch.scripts import blind_bench

torch.set_num_threads(1)

K_TRUE = jbench.gaussian_kernel()


def _opt(tmp, name, hr_dir, lr_dir, g):
    return {"name": name, "model": "sr", "scale": 4, "use_cem": True, "bf16": False, "watchdog": False,
            "datasets": {"test_1": {"name": "synth", "mode": "LRHR", "dataroot_HR": str(hr_dir),
                                    "dataroot_LR": str(lr_dir)}},
            "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4},
            "path": {"root": str(tmp), "pretrain_model_G": g}}


@pytest.fixture(scope="module")
def blind_data(tmp_path_factory):
    """Two 1/f HR 192 images and their LR 48 under the true kernel (PNGs),
    and a zeroed-output G as a JAX orbax checkpoint and as the port's .pth."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from esr_tpu.models.architecture import RRDBNet as JRRDBNet
    from esr_tpu.models.networks import rrdb_to_torch

    tmp = tmp_path_factory.mktemp("blind")
    hr_dir, lr_dir = tmp / "hr", tmp / "lr"
    cem_true = make_cem(CEMConf(scale=4, kernel=tuple(map(tuple, K_TRUE))), device="cpu")
    for i in range(2):
        hr = blind_bench.one_f_image(192, 192, seed=i)
        lr = cem_true.downsample(torch.from_numpy(hr)[None]).clamp(0, 1)[0].numpy()
        save_img(tensor2img(hr), str(hr_dir / f"img{i}.png"))
        save_img(tensor2img(lr), str(lr_dir / f"img{i}.png"))
    params = JRRDBNet(nf=8, nb=1, gc=4, scale=4).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    params["conv_last"]["Conv_0"] = jax.tree.map(jnp.zeros_like, params["conv_last"]["Conv_0"])
    jg = str(tmp / "zero_G")
    ocp.PyTreeCheckpointer().save(jg, {"params": jax.device_get(params)})
    pg = str(tmp / "zero_G.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in rrdb_to_torch(params).items()}, pg)
    return tmp, hr_dir, lr_dir, jg, pg, cem_true


def _true_residual(cem_true, res_dir, lr_dir) -> float:
    worst = 0.0
    for i in range(2):
        sr = torch.from_numpy(read_img(str(res_dir / f"img{i}.png")))[None]
        lr = torch.from_numpy(read_img(str(lr_dir / f"img{i}.png")))[None]
        worst = max(worst, (cem_true.downsample(sr) - lr).abs().max().item())
    return worst


def test_blind_eval_restores_true_consistency(blind_data, monkeypatch):
    import esr_tpu.cem.kernelgan as jkg
    from esr_tpu.test import main as jtest_main
    from esr_tpu_torch.test import main as test_main

    tmp, hr_dir, lr_dir, jg, pg, cem_true = blind_data
    calls = []

    def fake_estimate(lr_img, conf=None, **kw):
        calls.append((np.asarray(lr_img).shape, conf.iters))
        return K_TRUE.copy(), {"l_g": 0.0}

    monkeypatch.setattr(kernelgan, "estimate_kernel", fake_estimate)
    monkeypatch.setattr(jkg, "estimate_kernel", fake_estimate)

    def run(name, main, g, *flags):
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(_opt(tmp, name, hr_dir, lr_dir, g)))
        return main(["-opt", str(path), "--save_images", *flags])

    out = run("blind_on", test_main, pg, "--estimate_kernel", "50", "--device", "cpu")
    assert calls == [((48, 48, 3), 50)] and out["synth"]["cem_residual"] <= 1e-5
    res_blind = _true_residual(cem_true, tmp / "results" / "blind_on" / "synth", lr_dir)
    run("blind_off", test_main, pg, "--device", "cpu")
    res_wrong = _true_residual(cem_true, tmp / "results" / "blind_off" / "synth", lr_dir)
    assert res_blind < 5e-3, res_blind
    assert res_wrong > 10 * res_blind, (res_wrong, res_blind)
    run("blind_jax", jtest_main, jg, "--estimate_kernel", "50")
    assert len(calls) == 2
    for i in range(2):
        a = read_img_uint8(str(tmp / "results" / "blind_on" / "synth" / f"img{i}.png")).astype(int)
        b = read_img_uint8(str(tmp / "results" / "blind_jax" / "synth" / f"img{i}.png")).astype(int)
        assert a.shape == b.shape == (192, 192, 3) and np.abs(a - b).max() <= 1


def test_blind_model_restores_the_kernel_option(blind_data, monkeypatch):
    """The blind model is built under the estimate; ``opt['kernel']`` is put
    back for the datasets after it."""
    import logging

    from esr_tpu_torch import test as ptest
    from esr_tpu_torch.data import create_dataset
    from esr_tpu_torch.options import parse

    tmp, hr_dir, lr_dir, _, pg, _ = blind_data
    monkeypatch.setattr(kernelgan, "estimate_kernel", lambda lr, conf, **kw: (K_TRUE.copy(), {"l_g": 0.0}))
    opt = parse(_opt(tmp, "restore", hr_dir, lr_dir, pg), is_train=False)
    opt["kernel"] = [1.0, 2.0, 1.0]
    model = ptest._blind_model(opt, create_dataset(opt["datasets"]["test_1"]), True, logging.getLogger("t"), "cpu")
    assert model.cem._mode == "fft" and opt["kernel"] == [1.0, 2.0, 1.0]
    np.testing.assert_allclose(np.asarray(model.cem.conf.kernel), K_TRUE)


def test_explore_cli_estimate_kernel_builds_an_fft_session(blind_data):
    """build_session_from_opt(..., estimate_kernel_iters): the real estimator
    on the LR PNG (a few iterations), the session's CEM in fft mode under
    exactly the kernel a direct estimate gives, and consistent under it."""
    from esr_tpu_torch.explore import cli

    tmp, hr_dir, lr_dir, _, pg, _ = blind_data
    lr_png = str(lr_dir / "img0.png")
    sess = cli.build_session_from_opt(_opt(tmp, "explore", hr_dir, lr_dir, pg), lr_png, estimate_kernel_iters=20,
                                      device="cpu")
    want, _ = kernelgan.estimate_kernel(read_img(lr_png), kernelgan.conf_for_image((48, 48), 4, 20), device="cpu")
    assert sess.cem._mode == "fft"
    np.testing.assert_array_equal(np.asarray(sess.cem.conf.kernel), want)
    lr = torch.from_numpy(sess.lr_img)
    assert (sess.cem.downsample(torch.from_numpy(sess.current_sr())) - lr).abs().max().item() <= 1e-5


def test_estimate_kernel_script_writes_a_unit_sum_npy(blind_data, capsys):
    from esr_tpu_torch.scripts import estimate_kernel

    tmp, _, lr_dir, _, _, _ = blind_data
    out = str(tmp / "k.npy")
    estimate_kernel.main(["--lr", str(lr_dir / "img1.png"), "--iters", "120", "--g_input", "48", "--out", out,
                          "--watchdog", "0", "--device", "cpu"])
    k = np.load(out)
    assert k.shape == (21, 21) and abs(k.sum() - 1.0) < 1e-6
    assert np.asarray(resolve_kernel(out)).shape == (21, 21)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[100/120] l_g") and lines[1].startswith("[120/120]") and "saved 21x21" in lines[2]


def test_blind_bench_runs_and_keeps_the_jax_helpers():
    rng_kw = dict(h=40, w=36, seed=3)
    np.testing.assert_array_equal(blind_bench.one_f_image(**rng_kw), jbench.one_f_image(**rng_kw))
    np.testing.assert_array_equal(blind_bench.gaussian_kernel(9, 1.5, 1.0, 0.3), jbench.gaussian_kernel(9, 1.5, 1.0, 0.3))
    a, b = jbench.gaussian_kernel(), jbench.gaussian_kernel(sup=9)
    assert blind_bench.aligned_corr(a, b) == jbench.aligned_corr(a, b)
    (row,) = [r for r in blind_bench.main(["--iters", "20", "--sizes", "48", "--device", "cpu"])
              if r["kernel"] == "aniso_gauss"]
    assert row["iters"] == 20 and -1.0 <= row["corr"] <= 1.0 + 1e-9
    assert row["self_res_true"] <= 1e-5 and row["self_res_bicubic"] <= 1e-5 and row["true_res_true"] <= 1e-5
    assert row["true_res_bicubic"] > 1e-3  # the wrong kernel is inconsistent with the true operator
    assert all(np.isfinite(row[k]) for k in ("psnr_est", "psnr_true", "psnr_bicubic", "estimate_s"))


def test_export_under_a_2d_kernel_serves_the_live_forward(tmp_path):
    from esr_tpu_torch.export import export_servable, load_servable
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    opt = {"name": "exp", "model": "sr", "scale": 4, "use_cem": True, "bf16": False,
           "kernel": jbench.gaussian_kernel(sup=9).tolist(), "path": {"root": str(tmp_path)},
           "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1}}
    model = create_model(parse(opt, is_train=False), device="cpu")
    manifest = export_servable(model, [(1, 16, 16)], str(tmp_path / "art"))
    assert np.asarray(manifest["cem_kernel"]).shape == (9, 9)
    sv = load_servable(str(tmp_path / "art"), device="cpu")
    assert sv.cem._mode == model.cem._mode == "fft"
    rng = np.random.default_rng(0)
    lr = rng.random((16, 16, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (16, 16, 1)).astype(np.float32)
    want = model._forward(torch.from_numpy(lr)[None], torch.from_numpy(z)[None]).numpy()
    np.testing.assert_array_equal(sv.sr(lr, z), want)
    assert (sv.cem.downsample(torch.from_numpy(want)) - torch.from_numpy(lr)[None]).abs().max().item() <= 1e-5
