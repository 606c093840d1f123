"""The port's eval slice against the JAX package's, on the CPU: the eval CLI
(``esr_tpu_torch.test``), the models' eval surface, the self-ensemble and
the weight path from a JAX checkpoint.

Both sides run the same small explorable model (nf 16, nb 2, gc 8, one Z
channel, CEM, f32, fold 1) on the same weights: the JAX model's own init,
carried to the port as the ``.pth`` of ``rrdb_to_torch``. Tolerances:
PSNR within 0.01 dB, SSIM within 1e-4, Z diversity within 1e-3 relative
(the uint8 SRs may differ by one level where the f32 SRs straddle a
rounding boundary), CEM residuals at most 1e-5 on both sides, SR in f32
within 1e-4, Z draws bit-equal.
"""

import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu import data as jdata
from esr_tpu import test as jtest
from esr_tpu.models import create_model as jcreate_model
from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu.models.networks import rrdb_to_torch
from esr_tpu.ops.ensemble import make_self_ensemble as jmake_self_ensemble
from esr_tpu.options import parse as jparse
from esr_tpu_torch import test as ptest
from esr_tpu_torch.data import create_dataloader, create_dataset
from esr_tpu_torch.data.util import read_img_uint8, save_img
from esr_tpu_torch.models import create_model, define_G, state_dict_from_jax
from esr_tpu_torch.ops.ensemble import make_self_ensemble
from esr_tpu_torch.options import parse

torch.set_num_threads(1)

PSNR_TOL, SSIM_TOL, DIV_RTOL, CEM_TOL, SR_TOL = 1e-2, 1e-4, 1e-3, 1e-5, 1e-4


def _opt(root, hr_dir, **extra):
    opt = {
        "name": "eval_parity", "model": "srragan", "scale": 4, "use_cem": True, "bf16": False,
        "num_random_Z": 2, "eval_pad_bucket": 8, "watchdog": False,
        "datasets": {
            "test_1": {"name": "syn", "mode": "SYNTHETIC", "n_images": 2, "image_size": 32},
            "test_2": {"name": "folder", "mode": "LRHR", "dataroot_HR": hr_dir},
        },
        "path": {"root": root},
        "train": {"manual_seed": 0},
        "network_G": {"which_model_G": "RRDB_net", "nf": 16, "nb": 2, "gc": 8, "in_nc": 3,
                      "out_nc": 3, "num_latent_channels": 1, "latent_input": "first_layer", "fold": 1},
    }
    opt.update(extra)
    return opt


def _jax_params(model):
    return (getattr(model, "g_state", None) or model.state).params


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """An HR folder (one ragged image: modcrop and a bucket pad; one that
    fits the bucket), the JAX model and its weights as a .pth."""
    tmp = str(tmp_path_factory.mktemp("eval"))
    hr_dir = os.path.join(tmp, "hr")
    rng = np.random.default_rng(0)
    save_img((rng.random((46, 38, 3)) * 255).astype(np.uint8), os.path.join(hr_dir, "a.png"))
    save_img((rng.random((32, 32, 3)) * 255).astype(np.uint8), os.path.join(hr_dir, "b.png"))
    jmodel = jcreate_model(jparse(_opt(tmp, hr_dir), is_train=False))
    pth = os.path.join(tmp, "G.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in rrdb_to_torch(_jax_params(jmodel)).items()}, pth)
    return tmp, hr_dir, jmodel, pth


def _port_opt(setup, **extra):
    tmp, hr_dir, _, pth = setup
    opt = _opt(tmp, hr_dir, **extra)
    opt["path"]["pretrain_model_G"] = pth
    return opt


def _jax_eval(setup, opt_dict, model=None):
    opt = jparse(opt_dict, is_train=False)
    model = model or jcreate_model(opt)
    out = {}
    for phase, d in sorted(opt["datasets"].items()):
        ds = jdata.create_dataset(d)
        out[d["name"]] = jtest.evaluate_dataset(model, jdata.create_dataloader(ds, d), opt)
    return out


def _port_eval(opt_dict):
    opt = parse(opt_dict, is_train=False)
    model = create_model(opt, device="cpu")
    out = {}
    for phase, d in sorted(opt["datasets"].items()):
        ds = create_dataset(d)
        out[d["name"]] = ptest.evaluate_dataset(model, create_dataloader(ds, d), opt)
    return out


@pytest.mark.parametrize("extra", [{}, {"eval_batch": 2}, {"self_ensemble": True}],
                         ids=["serial", "batched", "self_ensemble"])
def test_evaluate_dataset_matches_jax(setup, extra):
    """evaluate_dataset of the port == esr_tpu.test.evaluate_dataset on the
    same weights and images: serial, eval_batch 2, self_ensemble; with
    eval_pad_bucket 8 and two random Z draws."""
    tmp, hr_dir, jmodel, _ = setup
    jopt = _opt(tmp, hr_dir, **extra)
    want = _jax_eval(setup, jopt, model=None if extra.get("self_ensemble") else jmodel)
    got = _port_eval(_port_opt(setup, **extra))
    for name in ("syn", "folder"):
        w, g = want[name], got[name]
        assert sorted(w) == sorted(g)
        for k in ("psnr", "z_psnr_mean"):
            assert abs(g[k] - w[k]) <= PSNR_TOL, (name, k, g[k], w[k])
        for k in ("ssim", "z_ssim_mean"):
            assert abs(g[k] - w[k]) <= SSIM_TOL, (name, k, g[k], w[k])
        for k in ("z_diversity", "z_diversity_textured"):
            assert abs(g[k] - w[k]) <= DIV_RTOL * abs(w[k]), (name, k, g[k], w[k])
        assert g["cem_residual"] <= CEM_TOL and w["cem_residual"] <= CEM_TOL


def test_batched_equals_serial(setup):
    """The port's batched evaluator gives the serial path's metrics (the
    same Z draws, the same scorer): equal to float rounding of the batch."""
    serial = _port_eval(_port_opt(setup))
    batched = _port_eval(_port_opt(setup, eval_batch=4))
    for name in serial:
        for k, v in serial[name].items():
            tol = CEM_TOL if k == "cem_residual" else 1e-9
            assert abs(batched[name][k] - v) <= tol, (name, k)


def test_sr_matches_jax_f32(setup):
    """One image through model.test with a random Z: the port's f32 SR equals
    the JAX model's to 1e-4, and both are CEM-consistent."""
    _, _, jmodel, _ = setup
    model = create_model(parse(_port_opt(setup), is_train=False), device="cpu")
    rng = np.random.default_rng(3)
    sample = {"LR": rng.random((12, 10, 3)).astype(np.float32)}
    z = jtest._eval_z_draw(0, 0, (12, 10), 1)
    jmodel.feed_data(sample)
    jmodel.test(z=z)
    model.feed_data(sample)
    model.test(z=z)
    want = jmodel.get_current_visuals()["SR"]
    got = model.get_current_visuals()["SR"]
    np.testing.assert_allclose(got, want, atol=SR_TOL)
    lr = torch.from_numpy(sample["LR"])[None]
    assert (model.cem.downsample(torch.from_numpy(got)[None]) - lr).abs().max().item() <= CEM_TOL
    np.testing.assert_array_equal(model.get_visuals_uint8()["SR"], jmodel.get_visuals_uint8()["SR"])


@pytest.mark.parametrize("idx,k,spatial,nz", [(0, 0, (8, 8), 1), (5, 1, (13, 7), 1), (2, 3, (4, 6), 2)])
def test_eval_z_draw_bit_equal(idx, k, spatial, nz):
    np.testing.assert_array_equal(ptest._eval_z_draw(idx, k, spatial, nz),
                                  jtest._eval_z_draw(idx, k, spatial, nz))


def test_pad_to_bucket_and_local_std_match_jax():
    rng = np.random.default_rng(4)
    lr = rng.random((11, 9, 3)).astype(np.float32)
    for bucket in (0, 8, 11):
        (gp, gh), (wp, wh) = ptest._pad_to_bucket(lr, bucket), jtest._pad_to_bucket(lr, bucket)
        np.testing.assert_array_equal(gp, wp)
        assert gh == wh
    gray = rng.random((20, 17))
    np.testing.assert_allclose(ptest._local_std_map(gray), jtest._local_std_map(gray), atol=1e-12)


def test_self_ensemble_matches_jax():
    """make_self_ensemble around the same small generator (no CEM) on a
    rectangular batch with Z: 1e-4."""
    jg = JRRDBNet(nf=8, nb=1, gc=4, scale=4, num_latent_channels=1)
    variables = jg.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))
    rng = np.random.default_rng(5)
    lr = rng.random((2, 9, 6, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (2, 9, 6, 1)).astype(np.float32)
    want = jax.jit(jmake_self_ensemble(jg.apply))(variables, jnp.asarray(lr), jnp.asarray(z))
    g = define_G({"network_G": {"nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1}, "scale": 4,
                  "bf16": False}, device="cpu")
    g.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = make_self_ensemble(g)(torch.from_numpy(lr), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_cli_end_to_end_writes_pngs_and_log(setup, tmp_path):
    """python -m esr_tpu_torch.test --device cpu --save_images: the log line,
    the returned metrics, and PNGs that decode to the SR uint8 of
    model.test on the same (padded) LR, cropped back."""
    tmp, hr_dir, _, pth = setup
    opt = _opt(str(tmp_path), hr_dir)
    opt["path"]["pretrain_model_G"] = pth
    opt_path = tmp_path / "opt.json"
    import json

    opt_path.write_text(json.dumps(opt))
    results = ptest.main(["-opt", str(opt_path), "--save_images", "--device", "cpu"])
    assert set(results) == {"syn", "folder"} and results["folder"]["cem_residual"] <= CEM_TOL
    out_dir = tmp_path / "results" / "eval_parity"
    logs = glob.glob(str(out_dir / "test_*.log"))
    assert logs and "[folder] avg PSNR:" in open(logs[0]).read()
    saved = sorted(os.listdir(out_dir / "folder"))
    assert saved == ["a.png", "a_z1.png", "a_z2.png", "b.png", "b_z1.png", "b_z2.png"]

    model = create_model(parse(opt, is_train=False), device="cpu")
    sample = create_dataset(parse(opt, is_train=False)["datasets"]["test_2"])[0]
    lr_p, orig = ptest._pad_to_bucket(sample["LR"], 8)
    assert orig == (11, 9) and lr_p.shape == (16, 16, 3)  # HR 46x38 -> modcrop 44x36
    model.feed_data({"LR": lr_p})
    model.test(z=ptest._eval_z_draw(0, 1, lr_p.shape[:2], 1))
    want = model.get_visuals_uint8()["SR"][:44, :36]
    np.testing.assert_array_equal(read_img_uint8(str(out_dir / "folder" / "a_z2.png")), want)


def test_weight_path_from_orbax(setup, tmp_path):
    """orbax checkpoint -> esr_tpu/scripts/export_torch_weights.py -> the
    port's load_network gives the SR of the JAX model restored from the
    checkpoint (1e-4); the orbax directory itself is refused with the
    script's name."""
    import orbax.checkpoint as ocp

    from esr_tpu.scripts import export_torch_weights

    tmp, hr_dir, jmodel, _ = setup
    params = jax.tree.map(lambda x: np.asarray(x) * 1.5, _jax_params(jmodel))  # not the init
    ckpt = str(tmp_path / "ckpt_G")
    ocp.PyTreeCheckpointer().save(ckpt, {"params": params}, force=True)
    pth = str(tmp_path / "G.pth")
    export_torch_weights.main(["--kind", "rrdb", "--ckpt", ckpt, "--out", pth])

    jopt = _opt(tmp, hr_dir)
    jopt["path"]["pretrain_model_G"] = ckpt
    jm = jcreate_model(jparse(jopt, is_train=False))
    popt = _opt(tmp, hr_dir)
    popt["path"]["pretrain_model_G"] = pth
    pm = create_model(parse(popt, is_train=False), device="cpu")
    rng = np.random.default_rng(6)
    sample = {"LR": rng.random((10, 12, 3)).astype(np.float32)}
    for m in (jm, pm):
        m.feed_data(sample)
        m.test()
    np.testing.assert_allclose(pm.get_current_visuals()["SR"], jm.get_current_visuals()["SR"], atol=SR_TOL)

    popt["path"]["pretrain_model_G"] = ckpt
    with pytest.raises(ValueError, match="export_torch_weights"):
        create_model(parse(popt, is_train=False), device="cpu")


def test_fold_runs_the_unfolded_forward(setup):
    """network_G.fold 2 (the shipped JSONs' value) computes what fold 1 does."""
    rng = np.random.default_rng(7)
    sample = {"LR": rng.random((8, 8, 3)).astype(np.float32)}
    outs = []
    for fold in (1, 2):
        opt = _port_opt(setup)
        opt["network_G"]["fold"] = fold
        m = create_model(parse(opt, is_train=False), device="cpu")
        m.feed_data(sample)
        m.test()
        outs.append(m.get_current_visuals()["SR"])
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("what", ["eval_tp", "eval_pp", "eval_spatial", "is_train", "estimate_kernel",
                                  "dataset_estimate_kernel", "train_phase", "packed", "non_separable"])
def test_not_ported_options_raise(setup, tmp_path, monkeypatch, what):
    """What the slice leaves out raises, naming where it waits. The options
    a later slice ported (blind eval, a non-separable kernel) run instead:
    tests/test_torch_blind.py and tests/test_torch_cem_modes.py hold them
    against the JAX package."""
    opt = _port_opt(setup)
    if what in ("eval_tp", "eval_pp", "eval_spatial"):
        with pytest.raises(NotImplementedError, match="item 10"):
            create_model(parse(dict(opt, **{what: 2}), is_train=False), device="cpu")
    elif what == "is_train":
        # training is ported (Queue 1 item 6); training over several devices is not
        with pytest.raises(NotImplementedError, match="item 10"):
            create_model(parse(dict(opt, train_tp=2), is_train=True), device="cpu")
    elif what == "non_separable":
        model = create_model(parse(dict(opt, kernel=np.ones((5, 4)).tolist()), is_train=False), device="cpu")
        assert model.cem._mode == "fft"
    elif what in ("train_phase", "packed"):
        # the train phase and PACKED are ported; LMDB has no backend in either package
        d = {"mode": "LRHR_LMDB" if what == "packed" else "LRHR", "phase": "train", "scale": 4,
             "dataroot_HR": "train.lmdb"}
        with pytest.raises(NotImplementedError, match="PACKED"):
            create_dataset(d)
    else:
        import json

        from esr_tpu_torch.cem import kernelgan

        seen = []
        monkeypatch.setattr(kernelgan, "estimate_kernel", lambda lr, conf, **kw: (
            seen.append((lr.shape, conf.iters, str(kw["device"]))) or np.ones((5, 4)) / 20, {"l_g": 0.0}))
        opt["datasets"]["test_1"]["image_size"] = 192  # LR 48: the estimator's least
        if what == "dataset_estimate_kernel":  # the flag on one dataset; the other keeps bicubic
            opt["datasets"]["test_1"]["estimate_kernel"] = 30
        else:  # the CLI flag estimates for every dataset: only LR >= 48 can take it
            del opt["datasets"]["test_2"]
        opt_path = tmp_path / "opt.json"
        opt_path.write_text(json.dumps(opt))
        argv = ["-opt", str(opt_path), "--device", "cpu"]
        results = ptest.main(argv + (["--estimate_kernel", "40"] if what == "estimate_kernel" else []))
        assert seen == [((48, 48, 3), 30 if what == "dataset_estimate_kernel" else 40, "cpu")]
        assert all(r["cem_residual"] <= CEM_TOL for r in results.values()) and "syn" in results


def test_entry_points_default_to_cuda(setup, tmp_path, monkeypatch):
    """test.main and create_model run on CUDA unless told otherwise, and raise
    on a host without it."""
    import json

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt_path = tmp_path / "opt.json"
    opt_path.write_text(json.dumps(_port_opt(setup)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptest.main(["-opt", str(opt_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(parse(copy.deepcopy(_port_opt(setup)), is_train=False))
