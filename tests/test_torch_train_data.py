"""The port's training data path against the JAX package's, on the CPU: the
train-phase crops of the LRHR, SYNTHETIC and PACKED datasets (numpy draws of
(seed, epoch, index): bit-equal), the loader's shuffle order and
``set_position``, and the device pipeline (the dihedral group, LR synthesis
by bicubic, blur + bicubic, a custom kernel's CEM downsample, paired LR)
with the augment codes JAX draws fed to the port.

Tolerances: crops, codes and orders exact; pipeline HR exact (a permutation
of the same f32 values); LR 1e-5 (f32 matmuls in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.cem import CEMConf as JCEMConf
from esr_tpu.cem import make_cem as jmake_cem
from esr_tpu.data import DataLoader as JDataLoader
from esr_tpu.data import create_dataset as jcreate_dataset
from esr_tpu.data.packed import write_packed as jwrite_packed
from esr_tpu.data.pipeline import dihedral_transform as jdihedral
from esr_tpu.data.pipeline import make_train_pipeline as jmake_pipeline
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.data import DataLoader, create_dataloader, create_dataset
from esr_tpu_torch.data.packed import write_packed
from esr_tpu_torch.data.pipeline import augment_codes, dihedral_transform, draw_z, make_train_pipeline
from esr_tpu_torch.data.util import save_img
from esr_tpu_torch.models.base_model import step_generator

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """HR PNGs (one smaller than the crop: reflect padding) and their LR."""
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((48, 40), (36, 44), (28, 30))):
        hr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        save_img(hr, str(root / "hr" / f"{i}.png"))
        save_img(hr[::4, ::4], str(root / "lr" / f"{i}.png"))
    return root


def _eq(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_samples(opt: dict, epochs=(0, 1)):
    ours, ref = create_dataset(dict(opt)), jcreate_dataset(dict(opt))
    assert len(ours) == len(ref)
    for epoch in epochs:
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert set(a) == set(b)
            _eq(a["HR"], b["HR"])
            _eq(a["LR"], b["LR"])
            assert a["HR_path"] == b["HR_path"]


@pytest.mark.parametrize("paired", [False, True], ids=["hr_only", "paired_lr"])
@pytest.mark.parametrize("on_device", [True, False], ids=["device", "host"])
def test_lrhr_train_crops_bit_equal(folders, paired, on_device):
    """LRHR train phase: uint8 crops (device processing) or host-processed
    float crops with bicubic LR and flips, per (seed, epoch, index)."""
    opt = {"mode": "LRHR", "phase": "train", "scale": 4, "HR_size": 32, "seed": 3,
           "dataroot_HR": str(folders / "hr"), "on_device_processing": on_device}
    if paired:
        opt["dataroot_LR"] = str(folders / "lr")
    _same_samples(opt)


def test_synthetic_and_packed_train_crops_bit_equal(tmp_path):
    _same_samples({"mode": "SYNTHETIC", "phase": "train", "scale": 4, "HR_size": 32, "n_images": 3,
                   "image_size": 40, "seed": 5})
    rng = np.random.default_rng(1)
    imgs = [(rng.random((40, 36, 3)) * 255).astype(np.uint8) for _ in range(3)]
    write_packed(imgs, str(tmp_path / "ours"), {"note": "x"})
    jwrite_packed(imgs, str(tmp_path / "ref"), {"note": "x"})
    for ext in (".npy", ".json"):
        assert (tmp_path / f"ours{ext}").read_bytes() == (tmp_path / f"ref{ext}").read_bytes()
    for hr_size in (32, [44, 30]):  # a crop taller than the images: reflect padding
        _same_samples({"mode": "PACKED", "phase": "train", "scale": 4, "HR_size": hr_size, "seed": 2,
                       "dataroot_HR": str(tmp_path / "ours.npy")})


def test_train_loader_order_and_set_position_match_jax():
    """Shuffle by seed + epoch, drop_last, epoch-aware crops, and a resumed
    position (epoch 1, two batches in) yield JAX's batches."""
    opt = {"mode": "SYNTHETIC", "phase": "train", "scale": 4, "HR_size": 16, "n_images": 7, "image_size": 24,
           "batch_size": 2, "seed": 4, "use_shuffle": True}
    ours = create_dataloader(create_dataset(dict(opt)), opt)
    ref = JDataLoader(jcreate_dataset(dict(opt)), batch_size=2, shuffle=True, drop_last=True, seed=4)
    assert len(ours) == len(ref) == 3

    def stream(loader, epochs):
        return [(b["HR_path"], b["HR"]) for _ in range(epochs) for b in loader]

    got, want = stream(ours, 2), stream(ref, 2)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        _eq(a, b)
    assert [p for p, _ in got[:3]] != [p for p, _ in got[3:]]  # epochs reshuffle
    ours.set_position(1, 2)
    ref.set_position(1, 2)
    got, want = stream(ours, 1), stream(ref, 1)
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) == 1
    _eq(got[0][1], want[0][1])
    # an eval loader keeps the dataset order, every image
    assert len(DataLoader(list(range(5)), batch_size=2)) == 3


def test_dihedral_transform_is_jax_group():
    img = np.random.default_rng(2).random((5, 5, 2)).astype(np.float32)
    for code in range(8):
        _eq(dihedral_transform(torch.from_numpy(img), code).numpy(), np.asarray(jdihedral(jnp.asarray(img), code)))


def _jax_codes(rng, n, use_flip, use_rot):
    """The codes JAX's pipeline draws from ``rng`` (its first split)."""
    rng_aug = jax.random.split(rng)[0]
    if use_flip and use_rot:
        return np.asarray(jax.random.randint(rng_aug, (n,), 0, 8)).tolist()
    if use_flip:
        return np.asarray(jax.random.randint(rng_aug, (n,), 0, 2)).tolist()
    if use_rot:
        return [(0, 2, 4, 5)[i] for i in np.asarray(jax.random.randint(rng_aug, (n,), 0, 4)).tolist()]
    return [0] * n


@pytest.mark.parametrize("flip,rot", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("lr_source", ["bicubic", "blur", "cem_kernel", "paired"])
def test_pipeline_matches_jax_with_its_codes(flip, rot, lr_source):
    n = 4
    rng = np.random.default_rng(7)
    hr = (rng.random((n, 16, 16, 3)) * 255).astype(np.uint8)
    lr = (rng.random((n, 4, 4, 3)) * 255).astype(np.uint8)
    kw = {"use_flip": flip, "use_rot": rot, "num_latent_channels": 1}
    batch = {"HR": hr, "LR": lr} if lr_source == "paired" else hr
    if lr_source == "blur":
        kw["blur_kernel"] = np.outer([1, 2, 1], [1, 2, 1, 0]).astype(np.float32) / 16
    jkw, pkw = dict(kw), dict(kw)
    if lr_source == "cem_kernel":
        k1 = (1.0, 3.0, 3.0, 1.0)
        jkw["downsample_fn"] = jmake_cem(JCEMConf(scale=4, kernel=k1)).downsample
        pkw["downsample_fn"] = make_cem(CEMConf(scale=4, kernel=k1), device="cpu").downsample
    key = jax.random.PRNGKey(11)
    want = jmake_pipeline(**jkw)(jax.tree.map(jnp.asarray, batch), key)
    codes = _jax_codes(key, n, flip, rot)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()} if isinstance(batch, dict) else torch.from_numpy(batch)
    got = make_train_pipeline(**pkw)(tb, torch.Generator().manual_seed(0), codes=codes)
    _eq(got["HR"].numpy(), np.asarray(want["HR"]))
    np.testing.assert_allclose(got["LR"].numpy(), np.asarray(want["LR"]), rtol=0, atol=1e-5)
    assert got["Z"].shape == want["Z"].shape == (n, 4, 4, 1)
    assert float(got["Z"].min()) >= -1.0 and float(got["Z"].max()) <= 1.0


def test_pipeline_draws_are_a_function_of_seed_and_step():
    """Codes and Z come from the step's generator: the same (seed, step)
    draws the same, another step draws others; the subgroups hold."""
    pipe = make_train_pipeline(num_latent_channels=2)
    hr = torch.from_numpy((np.random.default_rng(0).random((8, 16, 16, 3)) * 255).astype(np.uint8))
    a, b, c = (pipe(hr, step_generator(3, s)) for s in (5, 5, 6))
    assert torch.equal(a["Z"], b["Z"]) and torch.equal(a["HR"], b["HR"])
    assert not torch.equal(a["Z"], c["Z"])
    g = torch.Generator().manual_seed(1)
    assert set(augment_codes(g, 200, True, False)) == {0, 1}
    assert set(augment_codes(g, 200, False, True)) == {0, 2, 4, 5}
    assert set(augment_codes(g, 200, True, True)) == set(range(8))
    assert augment_codes(g, 3, False, False) == [0, 0, 0]
    assert draw_z(g, (2, 3), "zeros").abs().max() == 0
    with pytest.raises(ValueError, match="square"):
        pipe(hr[:, :, :8], g)


def test_lmdb_refused_with_packed_hint(tmp_path):
    with pytest.raises(NotImplementedError, match="PACKED"):
        create_dataset({"mode": "LRHR", "dataroot_HR": str(tmp_path / "x.lmdb")})
    with pytest.raises(FileNotFoundError):
        create_dataset({"mode": "PACKED", "phase": "train", "dataroot_HR": os.path.join(tmp_path, "none")})


@pytest.mark.parametrize("name", ["train_ESRGAN.json", "train_RRDB_PSNR.json", "train_explorable_SR.json"])
def test_train_options_copies_parse_as_jax(name):
    """The port's copies of the train JSONs are the JAX package's files and
    parse to the same dict."""
    from esr_tpu.options import parse as jparse
    from esr_tpu_torch.options import parse

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ours = os.path.join(repo, "esr_tpu_torch", "options", "train", name)
    ref = os.path.join(repo, "esr_tpu", "options", "train", name)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert parse(ours, is_train=True) == jparse(ref, is_train=True)


def test_check_resume_points_at_torch_checkpoints(tmp_path):
    """A resume state rewires pretrain_model_G (and D for a GAN model) to the
    .pth files saved beside it; set paths are kept."""
    from esr_tpu_torch.options import check_resume

    state = str(tmp_path / "exp" / "training_state" / "300.state")
    opt = {"model": "srragan", "path": {"resume_state": state, "pretrain_model_D": "keep.pth"}}
    check_resume(opt)
    assert opt["path"]["pretrain_model_G"] == str(tmp_path / "exp" / "models" / "300_G.pth")
    assert opt["path"]["pretrain_model_D"] == "keep.pth"
    opt = {"model": "sr", "path": {"resume_state": state}}
    check_resume(opt)
    assert "pretrain_model_D" not in opt["path"]
