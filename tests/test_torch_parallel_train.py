"""The port's trainers and evaluator over the parallel axes, on 2 ranks of a
gloo process group on the CPU (one ``comm.spawn`` for the module, bounded by
its timeout; tests/torch_parallel_workers.py is the rank side):

- the GAN step under ``dist``, ``train_tp`` (also with ``grad_clip`` set
  low enough to engage: the clip reads the whole gradient's norm on every
  rank, not the rank's slices') and ``train_pp`` from JAX's
  weights on a fixed batch: its metrics and parameters against JAX's step
  (tests/test_torch_train_helpers.py's bands, as tests/test_torch_train.py
  holds the one-process step) and against the one-process port step, G's
  gradients to f32 noise (BatchNorm's and RaGAN's batch statistics are the
  global batch's), every rank's parameters the same bit for bit;
  ``train_spatial`` at a crop its halo cannot cover runs and stays in step;
- the SR step under ``dist``, ``train_tp``, ``train_pp`` and
  ``train_spatial`` (a halo covering the receptive field: exact, as
  tests/test_train_step.py holds JAX's) through the trainer's own pipeline,
  against one process on the global batch;
- ``dist_eval`` and ``eval_batch`` equal to serial eval, and ``eval_tp``,
  ``eval_pp``, ``eval_spatial`` and their compositions within JAX's bound of
  serial eval (tests/test_e2e.py), rank 0 alone reporting.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from test_torch_train_helpers import (
    NOISE_GRADS,
    check_metrics,
    check_param_change,
    d_state_dict,
    fixed_batch,
    gan_opt,
    rel_l2,
    run_gan,
)
from esr_tpu_torch.models import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
    vgg_state_dict_from_jax,
)
from esr_tpu_torch.models.architecture import RRDBNet
from esr_tpu_torch.models import create_model
from esr_tpu_torch.options import parse
from esr_tpu_torch.parallel import comm

STEPS = 2
GAN_MODES = {"dist": {"dist": True}, "tp": {"train_tp": 2}, "pp": {"train_pp": 2}, "spatial": {"train_spatial": 2}}
CLIP = 0.05  # below G's gradient norm at both steps (checked), so Adam's global-norm clip engages
EVAL_EXACT = [{"dist_eval": True}, {"eval_batch": 2}, {"dist_eval": True, "eval_batch": 2}]
EVAL_SHARDED = [{"eval_tp": 2}, {"eval_pp": 2}, {"eval_tp": 2, "eval_batch": 2},
                {"eval_pp": 2, "eval_batch": 2, "eval_pp_micro": 2}, {"eval_tp": 2, "dist_eval": True}]
# LR 16 rows: 8 a shard, so a halo of 4 needs no padding (tests/test_e2e.py's 24 rows, halo 6)
EVAL_SPATIAL = [{"eval_spatial": 2, "eval_spatial_halo": 4},
                {"eval_spatial": 2, "eval_spatial_halo": 4, "dist_eval": True},
                {"eval_spatial": 2, "eval_spatial_halo": 4, "eval_batch": 2}]


def sr_opt(root: str, hr: int = 32, batch: int = 4, nb: int = 2, **extra) -> dict:
    opt = {"name": "sr_par", "model": "sr", "scale": 4, "bf16": False,
           "datasets": {"train": {"name": "syn", "mode": "SYNTHETIC", "n_images": 4, "image_size": 48,
                                  "batch_size": batch, "HR_size": hr}},
           "path": {"root": root},
           "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": nb, "gc": 4, "num_latent_channels": 1},
           "train": {"lr_G": 1e-3, "manual_seed": 0, "watchdog": False, "pixel_weight": 1.0}}
    opt.update(extra)
    return opt


def eval_opt(root: str) -> dict:
    return {"name": "par_eval", "model": "sr", "scale": 4, "bf16": False, "use_cem": True, "num_random_Z": 2,
            "datasets": {"test_1": {"name": "syn", "mode": "SYNTHETIC", "phase": "test", "n_images": 5,
                                    "image_size": 64}},
            "path": {"root": root},
            "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 2, "gc": 4, "num_latent_channels": 1}}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX and one-process references, and the 2-rank results."""
    root = str(tmp_path_factory.mktemp("par_train"))
    opt = gan_opt(root)
    opt["network_G"]["nb"] = 2  # the stage count divides it
    batch = fixed_batch(0)
    gan = run_gan(copy.deepcopy(opt), STEPS, batch)
    clip_train = dict(opt["train"], grad_clip=CLIP)
    gan_clip = run_gan(dict(copy.deepcopy(opt), train=clip_train), STEPS, batch)
    gan_modes = dict(GAN_MODES, tp_clip={"train_tp": 2, "train": clip_train})
    nets = gan["nets"]
    host = jax.device_get
    states = {"G": {k: v.numpy() for k, v in state_dict_from_jax(host(nets.g_params)).items()},
              "D": {k: v.numpy() for k, v in discriminator_state_dict_from_jax(host(nets.d_vars)).items()},
              "F": {k: v.numpy() for k, v in vgg_state_dict_from_jax(host(nets.f_vars)).items()}}
    sr_state = {k: v.numpy() for k, v in RRDBNet(nf=8, nb=2, gc=4, num_latent_channels=1, seed=5).state_dict().items()}
    sr_state1 = {k: v.numpy() for k, v in RRDBNet(nf=8, nb=1, gc=4, num_latent_channels=1, seed=5).state_dict().items()}
    hr = np.random.default_rng(1).random((4, 32, 32, 3)).astype(np.float32)
    hr_big = np.random.default_rng(2).random((2, 320, 320, 3)).astype(np.float32)
    big = dict(hr=320, batch=2, nb=1)
    sr = {"dist": (sr_opt(root, dist=True), sr_state, hr), "tp": (sr_opt(root, train_tp=2), sr_state, hr),
          "pp": (sr_opt(root, train_pp=2), sr_state, hr)}
    spatial = sr_opt(root, **big, train_spatial=2, train_spatial_halo=20)
    spatial["datasets"]["train"]["use_rot"] = False  # rot90 needs square crops; the strips are not
    sr["spatial"] = (spatial, sr_state1, hr_big)
    axes = ("dist", "train_tp", "train_pp", "train_spatial", "train_spatial_halo")
    single = {name: W.sr_steps({k: v for k, v in o.items() if k not in axes}, state, x, 2)
              for name, (o, state, x) in sr.items()}
    eo = eval_opt(root)
    serial = W.evaluate(eo, [{}])[0]
    payload = {"gan_opt": opt, "gan_modes": gan_modes, "gan_states": states, "gan_batch": batch,
               "gan_eps": [np.zeros((batch["HR"].shape[0], 1, 1, 1), np.float32)] * STEPS, "gan_steps": STEPS,
               "sr": sr, "eval_opt": eo, "eval_variants": EVAL_EXACT + EVAL_SHARDED + EVAL_SPATIAL}
    ranks = comm.spawn(W.training_and_eval_2, 2, tmp_path_factory.mktemp("ranks"), args=(payload,), timeout=120.0)
    return {"gan": gan, "gan_clip": gan_clip, "states": states, "single_sr": single, "serial": serial, "ranks": ranks, "sr": sr}


def _same_across_ranks(ranks, key: str) -> None:
    for net in ("G", "D") if "D" in ranks[0][key] else ("G",):
        for k, v in ranks[0][key][net].items():
            np.testing.assert_array_equal(ranks[1][key][net][k], v, err_msg=f"{key} {net} {k}")


@pytest.mark.parametrize("mode", ["dist", "tp", "pp", "tp_clip"])
def test_gan_step_matches_jax_and_one_process(case, mode):
    """Two GAN steps over 2 ranks: JAX's metrics and parameter changes, the
    one-process port step's metrics (the first step's to f32 noise) and G's first gradients
    (relative L2 1e-5; the float-noise biases aside), the same parameters on
    both ranks bit for bit. With ``grad_clip`` (``tp_clip``): the norm G's
    clip reads is the one-process gradient's, the same on both ranks (step 1
    to 3e-6: f32 noise reads 2e-7, one rank's slices alone 2e-5 off), and
    above the bound at every step."""
    gan, ranks = case["gan_clip" if mode == "tp_clip" else "gan"], case["ranks"]
    key = f"gan_{mode}"
    if mode == "tp_clip":
        one = [float(torch.sqrt(sum(g.pow(2).sum() for g in gs))) for gs in gan["g_opt"].grads]
        assert min(one) > CLIP, one
        assert ranks[0][key]["g_norms"] == ranks[1][key]["g_norms"]
        for r in ranks:
            assert min(r[key]["g_norms"]) > CLIP, r[key]["g_norms"]
            assert abs(r[key]["g_norms"][0] - one[0]) <= 3e-6 * one[0], (r[key]["g_norms"], one)
    check_metrics(gan["jmetrics"], [r for r in ranks[0][key]["metrics"]])
    # step 1 to f32 noise; later steps as check_metrics allows (Adam steps a
    # noise-level gradient by up to its learning rate, which step 2 reads)
    for i, (pm, rm) in enumerate(zip(gan["pmetrics"], ranks[0][key]["metrics"], strict=True)):
        for k, v in pm.items():
            scale = 1.0 if k in ("D_real", "D_fake") else abs(v)
            assert abs(rm[k] - v) <= (1e-5 if i == 0 else 1e-3) * scale + 1e-9, (mode, i + 1, k, rm[k], v)
    names = [n for n, _ in gan["model"].g_module.named_parameters()]
    for n, g1 in zip(names, gan["g_opt"].grads[0]):
        if n in NOISE_GRADS:
            continue
        assert rel_l2(ranks[0][key]["grads"][n], g1.numpy()) <= 1e-5, (mode, n)
    _same_across_ranks(ranks, key)
    lr = gan_opt("")["train"]["lr_G"]
    jg0, jg = gan["states"][0][0], gan["states"][-1][0]
    check_param_change(state_dict_from_jax(jax.device_get(jg0.params)), state_dict_from_jax(jax.device_get(jg.params)),
                       {k: torch.from_numpy(v) for k, v in ranks[0][key]["G"].items()}, lr, STEPS)
    check_param_change(d_state_dict(gan["states"][0][1]), d_state_dict(gan["states"][-1][1]),
                       {k: torch.from_numpy(v) for k, v in ranks[0][key]["D"].items()}, lr, STEPS)


def test_gan_step_shards(case):
    """The data-parallel ranks hold one row each; under train_tp each rank
    keeps half of every trunk conv kernel and of its Adam moments."""
    ranks = case["ranks"]
    assert [r["gan_dist"]["shard"] for r in ranks] == [(0, 2), (1, 2)]
    assert [r["gan_tp"]["shard"] for r in ranks] == [(0, 1), (0, 1)]
    g = RRDBNet(nf=8, nb=2, gc=4, num_latent_channels=1)
    weights = sum(p.numel() for n, p in g.named_parameters() if n.startswith("RRDB") and n.endswith("weight"))
    biases = sum(p.numel() for n, p in g.named_parameters() if n.startswith("RRDB") and n.endswith("bias"))
    for r in ranks:
        assert r["gan_tp"]["trunk_numel"] == r["gan_tp"]["trunk_moments"] == weights // 2 + biases
        assert r["gan_dist"]["trunk_numel"] == weights + biases


def test_gan_step_spatial_runs(case):
    """train_spatial at HR 32 (LR 8, 4 rows a rank, halo 2: below the
    receptive field, so approximate): finite metrics near the one-process
    step's, the same parameters on both ranks."""
    gan, ranks = case["gan"], case["ranks"]
    for pm, rm in zip(gan["pmetrics"], ranks[0]["gan_spatial"]["metrics"], strict=True):
        assert all(np.isfinite(v) for v in rm.values())
        assert abs(rm["l_g"] - pm["l_g"]) < 0.1 * abs(pm["l_g"]), (rm["l_g"], pm["l_g"])
    _same_across_ranks(ranks, "gan_spatial")


@pytest.mark.parametrize("mode", ["dist", "tp", "pp", "spatial"])
def test_sr_step_matches_one_process(case, mode):
    """Two SR-trainer steps through the trainer's own pipeline (augment codes
    and Z drawn for the global batch): the loss, PSNR and parameters of one
    process on the global batch (the spatial halo covers the receptive field:
    exact to float noise), the same parameters on both ranks."""
    single, ranks = case["single_sr"][mode], case["ranks"]
    key = f"sr_{mode}"
    for sm, rm in zip(single["metrics"], ranks[0][key]["metrics"], strict=True):
        for k, v in sm.items():
            assert abs(rm[k] - v) <= 1e-5 * abs(v), (mode, k, rm[k], v)
    before = case["sr"][mode][1]
    check_param_change({k: torch.from_numpy(v) for k, v in before.items()},
                       {k: torch.from_numpy(v) for k, v in single["G"].items()},
                       {k: torch.from_numpy(v) for k, v in ranks[0][key]["G"].items()}, 1e-3, 2)
    _same_across_ranks(ranks, key)


@pytest.mark.parametrize("i", range(len(EVAL_EXACT)))
def test_dist_eval_matches_serial(case, i):
    """dist_eval (images dealt over 2 ranks by pad buckets, the last one
    repeated) and eval_batch: the serial path's metrics exactly (Z draws are a
    pure function of (image, draw)); rank 1 reports nothing."""
    got, other = case["ranks"][0]["eval"][i], case["ranks"][1]["eval"][i]
    assert other == {}
    assert set(got) == set(case["serial"])
    for k, v in case["serial"].items():
        assert np.isclose(got[k], v, rtol=0, atol=1e-9), (EVAL_EXACT[i], k, got[k], v)


@pytest.mark.parametrize("i", range(len(EVAL_SHARDED)))
def test_sharded_eval_matches_serial(case, i):
    """eval_tp, eval_pp and their batched compositions: serial eval's
    metrics within JAX's bound (1e-3, float reduction order)."""
    got = case["ranks"][0]["eval"][len(EVAL_EXACT) + i]
    assert case["ranks"][1]["eval"][len(EVAL_EXACT) + i] == {}
    for k, v in case["serial"].items():
        assert np.isclose(got[k], v, rtol=0, atol=1e-3), (EVAL_SHARDED[i], k, got[k], v)


@pytest.mark.parametrize("i", range(len(EVAL_SPATIAL)))
def test_spatial_eval_matches_serial(case, i):
    """eval_spatial, alone and with dist_eval / eval_batch: serial eval's
    PSNR within JAX's bound (0.05 dB: the seams' halo decay), the CEM
    residual exact (one projection of the assembled output)."""
    got = case["ranks"][0]["eval"][len(EVAL_EXACT) + len(EVAL_SHARDED) + i]
    assert abs(got["psnr"] - case["serial"]["psnr"]) < 0.05, (EVAL_SPATIAL[i], got, case["serial"])
    assert got["cem_residual"] < 1e-5, (EVAL_SPATIAL[i], got)


def test_parallel_option_errors(tmp_path):
    """The options JAX refuses raise the same errors, before any mesh."""
    def make(opt, is_train):
        return create_model(parse(opt, is_train=is_train), device="cpu")

    eo = eval_opt(str(tmp_path))
    for extra, match in (({"eval_tp": 2, "eval_pp": 2}, "mutually exclusive"),
                         ({"eval_spatial": 2, "eval_pp": 2}, "mutually exclusive"),
                         ({"eval_spatial": 2, "eval_tp": 2, "dist_eval": True}, "does not additionally compose"),
                         ({"eval_tp": True}, "shard count"), ({"eval_pp": 1}, "shard count")):
        with pytest.raises(ValueError, match=match):
            make(dict(eo, **extra), False)
    for extra, match in (({"train_tp": 2, "train_pp": 2}, "mutually exclusive"),
                         ({"train_spatial": 2, "train_pp": 2}, "mutually exclusive"),
                         ({"train_spatial": 3}, "does not divide over"),
                         ({"train_spatial": 2, "train_spatial_halo": 3}, "needs 2\\*halo"),
                         ({"train_spatial": 8}, "leave 1 LR rows")):
        with pytest.raises(ValueError, match=match):
            make(sr_opt(str(tmp_path), **extra), True)
