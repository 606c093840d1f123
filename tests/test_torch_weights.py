"""The port's weight-file tools against the JAX package's, on the CPU (f32):

- a reference generator file in either key layout (new; the ``.0`` of the
  reference's ``Sequential(conv, LeakyReLU)`` convs; the old ``model.N``
  layout) loads strictly through ``BaseModel.load_network`` and gives JAX's
  forward after ``load_rrdb_from_torch`` on the same file, to 2e-5;
- ``scripts/convert_torch_weights`` writes what the strict loaders take, and
  refuses what they would refuse;
- ``scripts/net_interp`` equals JAX's ``interp_trees`` key by key (to 1e-6)
  and refuses differing keys or shapes.

Weights: JAX's own init of RRDBNet nf 8, gc 4 (nb 2, and nb 23 where the
old layout's ``model.1.sub.23`` names trunk_conv for JAX too), as
``rrdb_to_torch`` writes them.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu.models.networks import load_rrdb_from_torch, rrdb_to_torch
from esr_tpu.scripts.net_interp import interp_trees
from esr_tpu_torch.models import create_model, define_D, define_F
from esr_tpu_torch.options import parse
from esr_tpu_torch.scripts import convert_torch_weights, net_interp

FWD_TOL = 2e-5
OLD_NAMES = {"conv_first": "model.0", "upconv1": "model.3", "upconv2": "model.6", "HRconv": "model.8",
             "conv_last": "model.10"}


def jax_state(nb: int, seed: int = 0) -> tuple[JRRDBNet, dict]:
    module = JRRDBNet(nf=8, nb=nb, gc=4, scale=4, num_latent_channels=1)
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))["params"]
    return module, {k: np.array(v) for k, v in rrdb_to_torch(params).items()}


def layout(state: dict, name: str, nb: int) -> dict:
    """``state`` (new keys) in the reference layout ``name``."""
    out = {}
    for k, v in state.items():
        base, leaf = k.rsplit(".", 1)
        if name in ("dot0", "old") and (base in OLD_NAMES or base in ("trunk_conv",) or ".RDB" in base):
            base += ".0" if ".RDB" in base else ""
        if name == "old":
            m = re.match(r"RRDB_trunk\.(\d+)\.(.+)$", base)
            base = (f"model.1.sub.{m[1]}.{m[2]}" if m else f"model.1.sub.{nb}" if base == "trunk_conv"
                    else OLD_NAMES.get(base, base))
        out[f"{base}.{leaf}"] = v
    return out


def port_forward(pth: str, nb: int, lr: np.ndarray, z: np.ndarray) -> np.ndarray:
    opt = {"model": "sr", "scale": 4, "bf16": False, "path": {"pretrain_model_G": pth},
           "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": nb, "gc": 4, "num_latent_channels": 1}}
    model = create_model(parse(opt, is_train=False), device="cpu")
    with torch.no_grad():
        return model.g_module(torch.from_numpy(lr), torch.from_numpy(z)).numpy()


@pytest.mark.parametrize("name, nb", [("new", 2), ("dot0", 2), ("old", 2), ("old", 23)])
def test_reference_layouts_load_and_match_jax(tmp_path, name, nb):
    """The port loads the file strictly and its forward equals JAX's on the
    same file (JAX reads the old layout's trunk_conv as ``model.1.sub.23``
    only, so at nb 2 it is given the ``.0`` file of the same weights)."""
    module, state = jax_state(nb)
    file_state = layout(state, name, nb)
    if name == "old":
        assert "model.1.sub.0.RDB1.conv1.0.weight" in file_state and f"model.1.sub.{nb}.weight" in file_state
    pth = str(tmp_path / "G.pth")
    torch.save({k: torch.from_numpy(v) for k, v in file_state.items()}, pth)
    rng = np.random.default_rng(1)
    lr = rng.random((1, 8, 8, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (1, 8, 8, 1)).astype(np.float32)
    jax_file = file_state if name != "old" or nb == 23 else layout(state, "dot0", nb)
    want = np.asarray(module.apply(load_rrdb_from_torch(jax_file, nb=nb), jnp.asarray(lr), jnp.asarray(z)))
    np.testing.assert_allclose(port_forward(pth, nb, lr, z), want, rtol=0, atol=FWD_TOL)


def test_load_network_unwraps_and_stays_strict(tmp_path):
    """A ``{"state_dict": ...}`` wrapper is unwrapped; an unknown key, a
    missing key, or two keys for one parameter still raise."""
    _, state = jax_state(2)
    old = {k: torch.from_numpy(v) for k, v in layout(state, "old", 2).items()}
    pth = str(tmp_path / "G.pth")
    torch.save({"state_dict": old}, pth)
    lr, z = np.zeros((1, 8, 8, 3), np.float32), np.zeros((1, 8, 8, 1), np.float32)
    assert np.isfinite(port_forward(pth, 2, lr, z)).all()
    bad = {"unknown": dict(old, **{"model.12.weight": old["model.0.weight"]}),
           "missing": {k: v for k, v in old.items() if k != "model.8.bias"},
           "twice": dict(old, **{"conv_first.weight": old["model.0.weight"]})}
    for why, st in bad.items():
        torch.save(st, pth)
        with pytest.raises((RuntimeError, ValueError)):
            port_forward(pth, 2, lr, z)


def test_convert_torch_weights(tmp_path):
    """rrdb: the old layout in, the port's keys out (a plain strict load
    takes them); discriminator and vgg19 pass through their strict loaders;
    a file they would refuse raises."""
    _, state = jax_state(2)
    src, out = str(tmp_path / "in.pth"), str(tmp_path / "out.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in layout(state, "old", 2).items()}}, src)
    convert_torch_weights.main(["--kind", "rrdb", "--pth", src, "--out", out])
    got = torch.load(out, weights_only=True)
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    d_opt = {"network_D": {"nf": 8}, "datasets": {"train": {"HR_size": 64}}, "bf16": False}
    d_state = define_D(d_opt, device="cpu", seed=3).state_dict()
    torch.save(d_state, src)
    convert_torch_weights.main(["--kind", "discriminator", "--pth", src, "--out", out])
    assert sorted(torch.load(out, weights_only=True)) == sorted(d_state)
    vgg = define_F({"bf16": False}, device="cpu").state_dict()
    vgg["classifier.0.weight"] = torch.zeros(2, 2)  # a torchvision file's classifier rides along
    torch.save(vgg, src)
    convert_torch_weights.main(["--kind", "vgg19", "--pth", src, "--out", out])
    assert sorted(torch.load(out, weights_only=True)) == sorted(vgg)
    for kind, st in (("vgg19", {k: v for k, v in vgg.items() if k != "features.34.bias"}),
                     ("discriminator", dict(d_state, extra=torch.zeros(1))),
                     ("rrdb", {k: torch.from_numpy(v) for k, v in state.items() if k != "HRconv.bias"})):
        torch.save(st, src)
        with pytest.raises((KeyError, RuntimeError)):
            convert_torch_weights.main(["--kind", kind, "--pth", src, "--out", out])


def test_net_interp_matches_jax(tmp_path):
    """The interpolated state equals JAX's ``interp_trees`` on the same two
    weight sets (one of them in the old layout on disk) to 1e-6."""
    _, a = jax_state(2, seed=0)
    _, b = jax_state(2, seed=1)
    pa, pb, out = (str(tmp_path / n) for n in ("a.pth", "b.pth", "out.pth"))
    torch.save({k: torch.from_numpy(v) for k, v in a.items()}, pa)
    torch.save({k: torch.from_numpy(v) for k, v in layout(b, "old", 2).items()}, pb)
    net_interp.main(["--model_psnr", pa, "--model_gan", pb, "--alpha", "0.3", "--out", out])
    got = torch.load(out, weights_only=True)
    want = interp_trees(a, b, 0.3)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0, atol=1e-6, err_msg=k)
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    with pytest.raises(ValueError, match="keys differ"):
        net_interp.interp_state_dicts(ta, {k: v for k, v in ta.items() if k != "HRconv.bias"}, 0.5)
    with pytest.raises(ValueError, match="shapes"):
        net_interp.interp_state_dicts(ta, dict(ta, **{"HRconv.bias": torch.zeros(3)}), 0.5)
