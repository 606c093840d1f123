"""The port's scripts against the JAX package's, on the CPU (f32, small
nets):

- data prep: ``generate_mod_lr_bic`` (x2 / x3 / x4 with the bicubic
  re-upscale), ``extract_subimages`` and ``create_packed_dataset`` on a
  folder of 1/f PNGs: every decoded uint8 image equal (0 pixels differ;
  the PNG encoders differ, so file bytes are not compared), the packed
  array and its meta equal byte for byte;
- the precision ladder's tools: ``one_over_f_image`` bit-equal, ``metrics``
  to 1e-12, the ``f32_plain`` oracle (and, on the CPU, the kernel
  variants' plain versions) against JAX's ``f32_highest`` forward of the
  same weights to 1e-5;
- ``run_parity_eval`` against JAX's on the same ``.pth`` (the port's in the
  old reference layout): PSNR / SSIM / random-Z metrics to 1e-3 dB / 1e-4
  (both reports round to 4 decimals), the schema equal;
- ``explore_bench`` and ``ensemble_bench`` emit their JSON line at nb 1;
- ``quickstart --niter 4 --device cpu`` trains, evaluates and edits.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu.models.networks import rrdb_to_torch
from esr_tpu.scripts import create_packed_dataset as jpack
from esr_tpu.scripts import extract_subimages as jsub
from esr_tpu.scripts import generate_mod_lr_bic as jgen
from esr_tpu.scripts import precision_ladder as jladder
from esr_tpu.scripts.parity_eval import run_parity_eval as jrun_parity_eval
from esr_tpu_torch.data.util import read_img_uint8, save_img
from esr_tpu_torch.models import state_dict_from_jax
from esr_tpu_torch.scripts import create_packed_dataset, ensemble_bench, explore_bench, extract_subimages
from esr_tpu_torch.scripts import generate_mod_lr_bic, precision_ladder, quickstart
from esr_tpu_torch.scripts.parity_eval import run_parity_eval

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three 1/f PNGs, sizes not multiples of 2, 3 or 4."""
    d = tmp_path_factory.mktemp("imgs")
    for i, (h, w) in enumerate([(50, 41), (64, 64), (37, 53)]):
        img = precision_ladder.one_over_f_image(h, w, seed=i)
        save_img((img * 255).round().astype(np.uint8), str(d / "in" / f"img{i}.png"))
    return d


def _same_images(a_dir: str, b_dir: str) -> int:
    """Every PNG under ``a_dir`` decodes to the uint8 array of its twin under ``b_dir``; returns the count."""
    n = 0
    for root, _, files in os.walk(a_dir):
        for f in sorted(files):
            a = read_img_uint8(os.path.join(root, f))
            b = read_img_uint8(os.path.join(b_dir, os.path.relpath(os.path.join(root, f), a_dir)))
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, f
            assert int((a != b).sum()) == 0, (f, int(np.abs(a.astype(int) - b.astype(int)).max()))
            n += 1
    return n


def test_generate_mod_lr_bic_matches_jax(folder):
    args = ["--input", str(folder / "in"), "--scales", "2", "3", "4", "--save_bic_up"]
    jgen.main(args + ["--output", str(folder / "gen_jax")])
    generate_mod_lr_bic.main(args + ["--output", str(folder / "gen_port")])
    assert _same_images(str(folder / "gen_jax"), str(folder / "gen_port")) == 3 * 3 * 3


def test_extract_subimages_matches_jax(folder):
    args = ["--input", str(folder / "in"), "--crop_size", "32", "--step", "16", "--threshold", "4"]
    jsub.main(args + ["--output", str(folder / "sub_jax")])
    extract_subimages.main(args + ["--output", str(folder / "sub_port")])
    assert sorted(os.listdir(folder / "sub_jax")) == sorted(os.listdir(folder / "sub_port"))
    assert _same_images(str(folder / "sub_jax"), str(folder / "sub_port")) == len(os.listdir(folder / "sub_jax"))


def test_create_packed_dataset_matches_jax(folder):
    args = ["--input", str(folder / "in"), "--size", "48"]  # two images are padded up, one cropped
    jpack.main(args + ["--output", str(folder / "pack_jax")])
    create_packed_dataset.main(args + ["--output", str(folder / "pack_port")])
    for ext in (".npy", ".json"):
        assert (folder / f"pack_jax{ext}").read_bytes() == (folder / f"pack_port{ext}").read_bytes(), ext


def _jax_weights(nb: int = 1, seed: int = 0):
    module = JRRDBNet(nf=8, nb=nb, gc=4, scale=4, num_latent_channels=1)
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))["params"]
    return params, {k: np.array(v) for k, v in rrdb_to_torch(params).items()}


def test_ladder_tools_match_jax():
    for h, w, seed in ((64, 48, 0), (13, 7, 3)):
        np.testing.assert_array_equal(precision_ladder.one_over_f_image(h, w, seed), jladder.one_over_f_image(h, w, seed))
    rng = np.random.default_rng(0)
    a, b = rng.random((5, 6, 3)).astype(np.float32), rng.random((5, 6, 3)).astype(np.float32)
    for k, v in jladder.metrics(a, b).items():
        assert abs(precision_ladder.metrics(a, b)[k] - v) <= 1e-12, k
    params, _ = _jax_weights()
    want = jladder._forward(params, 8, 1, 4, 1, (12, 10), "f32_highest")
    got = precision_ladder.run_variants(
        state_dict_from_jax(jax.device_get(params)),
        ("f32_plain", "f32_kernels", "bf16_plain", "bf16_kernels"), (12, 10), "cpu")
    for v in ("f32_plain", "f32_kernels"):
        np.testing.assert_allclose(got[v], want, rtol=0, atol=1e-5, err_msg=v)
    for v in ("bf16_plain", "bf16_kernels"):  # bf16: finite and within bf16 resolution of the oracle
        assert np.abs(got[v] - want).max() <= 0.05 * np.abs(want).max(), v


@pytest.mark.parametrize("use_cem, nz_draws", [(False, 0), (True, 2)], ids=["psnr_model", "explorable_cem"])
def test_run_parity_eval_matches_jax(folder, tmp_path, use_cem, nz_draws):
    """The same checkpoint (new layout for JAX, old for the port) and images:
    the reports agree."""
    _, state = _jax_weights(nb=2, seed=1)
    pj, pp = str(tmp_path / "G_new.pth"), str(tmp_path / "G_old.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, pj)
    from test_torch_weights import layout

    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in layout(state, "old", 2).items()}}, pp)
    kw = dict(images=str(folder / "in"), nb=2, nf=8, gc=4, use_cem=use_cem, num_random_z=nz_draws)
    want = jrun_parity_eval(pj, out=str(tmp_path / "jax.json"), **kw)
    got = run_parity_eval(pp, out=str(tmp_path / "port.json"), device="cpu", **kw)
    assert json.loads((tmp_path / "port.json").read_text())["psnr"] == got["psnr"]
    assert sorted(got) == sorted(want) and got["protocol"] == want["protocol"]
    assert got["num_latent_channels"] == want["num_latent_channels"] == 1
    for k, tol in (("psnr", 1e-3), ("set5_psnr_delta", 1e-3), ("ssim", 1e-4), ("z_psnr_mean", 1e-3)):
        if k in want:
            assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    if use_cem:
        assert got["cem_residual"] <= 1e-5 and want["cem_residual"] <= 1e-5


def _json_line(capsys) -> dict:
    return json.loads([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1])


def test_explore_bench_emits_json(capsys):
    explore_bench.main(["--device", "cpu", "--nb", "1", "--lr_size", "16", "--regions", "4", "--n_steps", "4",
                        "--iters", "2", "--alternatives", "2"])
    rec = _json_line(capsys)
    assert rec["metric"] == "explore_click_latency" and rec["platform"] == "cpu" and rec["value"] > 0
    (click,) = rec["clicks"]
    assert click["region_lr"] == 4 and click["steps_per_s"] > 0 and click["first_s"] > 0
    assert rec["render_s"]["repeat"] > 0 and rec["adaptive_imprint"]["rounds"] >= 1
    assert rec["alternatives"]["k"] == 2 and rec["alternatives"]["repeat_s"] > 0


def test_ensemble_bench_emits_json(tmp_path, capsys):
    opt = {"name": "e", "model": "sr", "scale": 4, "use_cem": True, "bf16": False, "num_random_Z": 1,
           "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1}}
    (tmp_path / "o.json").write_text(json.dumps(opt))
    ensemble_bench.main(["--device", "cpu", "--opt", str(tmp_path / "o.json"), "--n", "2", "--size", "32",
                         "--time_lr", "16", "--iters", "2"])
    rec = _json_line(capsys)
    assert rec["metric"] == "self_ensemble_ledger" and rec["platform"] == "cpu"
    for side in ("plain", "ensemble"):
        assert rec[side]["mp_per_s"] > 0 and rec[side]["cem_residual"] <= 1e-5
    assert rec["psnr_delta_db"] == rec["ensemble"]["psnr"] - rec["plain"]["psnr"] and rec["cost_factor"] > 1


def test_quickstart_runs(tmp_path):
    edited = quickstart.main(["--root", str(tmp_path), "--niter", "4", "--device", "cpu"])
    img = read_img_uint8(edited)
    assert img.shape == (384, 384, 3)  # the first synthetic image (96 px) as the LR, x 4
    exp = tmp_path / "experiments" / "quickstart"
    assert (exp / "models" / "latest_G.pth").exists() and (exp / "training_state" / "4.state").exists()
    assert list((tmp_path / "results" / "quickstart_eval" / "syn_val").glob("*.png"))
