"""The port's generator (esr_tpu_torch.models) against the JAX package's.

JAX params are bridged into the port with ``state_dict_from_jax`` and both
run f32 on the CPU on the same numpy inputs. The JAX RDB defaults to the
per-source packed form, the port computes the dense concat: they differ only
in summation order, so outputs agree at atol 2e-5 (the precedent of
tests/test_models.py's torch-oracle parity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu.models.blocks import RRDB as JRRDB
from esr_tpu.models.blocks import ResidualDenseBlock5C as JRDB
from esr_tpu.models.networks import rrdb_to_torch
from esr_tpu_torch.models import RRDBNet, define_G, state_dict_from_jax
from esr_tpu_torch.models.blocks import RRDB, ResidualDenseBlock5C, kaiming_scaled

torch.set_num_threads(1)

ATOL = 2e-5
NF, GC = 8, 4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load_convs(module, tree, prefix=""):
    """Flax conv{k}/Conv_0/{kernel,bias} subtree -> the port module's params."""
    sd = {}
    for k in range(1, 6):
        c = tree[f"conv{k}"]["Conv_0"]
        sd[f"{prefix}conv{k}.weight"] = _t(np.transpose(c["kernel"], (3, 2, 0, 1)))
        sd[f"{prefix}conv{k}.bias"] = _t(c["bias"])
    return sd


def test_rdb_module_matches_flax():
    x = np.random.default_rng(0).standard_normal((2, 12, 10, NF)).astype(np.float32)
    jblock = JRDB(nf=NF, gc=GC)
    variables = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    block = ResidualDenseBlock5C(NF, GC)
    block.load_state_dict(_load_convs(block, variables["params"]), strict=True)
    np.testing.assert_allclose(block(_t(x)).detach().numpy(), ref, atol=ATOL)


def test_rrdb_module_matches_flax():
    x = np.random.default_rng(1).standard_normal((1, 9, 11, NF)).astype(np.float32)
    jblock = JRRDB(nf=NF, gc=GC)
    variables = jblock.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    block = RRDB(NF, GC)
    sd = {}
    for j in (1, 2, 3):
        sd.update(_load_convs(block, variables["params"][f"rdb{j}"], prefix=f"RDB{j}."))
    block.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(block(_t(x)).detach().numpy(), ref, atol=ATOL)


def _jax_net(scale, nz, nb=2, scan=True):
    model = JRRDBNet(nf=NF, nb=nb, gc=GC, scale=scale, num_latent_channels=nz, scan_blocks=scan)
    args = (jnp.zeros((1, 8, 8, 3)),) + ((jnp.zeros((1, 8, 8, nz)),) if nz else ())
    return model, model.init(jax.random.PRNGKey(scale + nz), *args)


@pytest.mark.parametrize("scale,nz", [(4, 1), (2, 0), (3, 0)], ids=["x4_nz1", "x2_nz0", "x3_nz0"])
def test_rrdbnet_matches_jax(scale, nz):
    """Bridged weights: the port's RRDBNet equals RRDBNet.apply (fused 2x
    upsample for x2/x4, materialized nearest upsample for x3)."""
    model, variables = _jax_net(scale, nz)
    rng = np.random.default_rng(scale)
    lr = rng.random((2, 10, 12, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (2, 10, 12, nz)).astype(np.float32) if nz else None
    ref = np.asarray(model.apply(variables, jnp.asarray(lr), None if z is None else jnp.asarray(z)))
    net = RRDBNet(nf=NF, nb=2, gc=GC, scale=scale, num_latent_channels=nz)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = net(_t(lr), None if z is None else _t(z))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("layout", ["scan", "unrolled"])
def test_weight_bridge_equals_rrdb_to_torch(layout):
    """state_dict_from_jax == esr_tpu's rrdb_to_torch key for key and value
    for value, and loads into the port with strict=True."""
    _, variables = _jax_net(4, 1, scan=layout == "scan")
    ours = state_dict_from_jax(variables)
    ref = rrdb_to_torch(variables)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    net = RRDBNet(nf=NF, nb=2, gc=GC, scale=4, num_latent_channels=1)
    assert set(net.state_dict()) == set(ours)
    net.load_state_dict(ours, strict=True)


def test_define_g_options():
    """define_G reads the reference options dict; fold/packed change nothing."""
    opt = {"network_G": {"which_model_G": "RRDB_net", "nf": NF, "nb": 1, "gc": GC,
                         "num_latent_channels": 1, "fold": 2, "packed": True},
           "scale": 4}
    g = define_G(opt, device="cpu", seed=3)
    assert g.dtype == torch.bfloat16 and not g.training
    assert g.conv_first.weight.shape == (NF, 4, 3, 3)
    g2 = define_G(dict(opt, bf16=False, network_G=dict(opt["network_G"], fold=1, packed=False)),
                  device="cpu", seed=3)
    assert g2.dtype == torch.float32
    for (k, a), b in zip(g.state_dict().items(), g2.state_dict().values()):
        assert torch.equal(a, b), k
    # the variants that raised until their slice (tests/test_torch_generators.py)
    g3 = define_G({"network_G": dict(opt["network_G"], latent_input="all_layers")}, device="cpu", seed=3)
    assert g3.all_layers and len(g3.latent_proj) == 1
    assert type(define_G({"network_G": {"which_model_G": "sr_resnet", "nf": NF}}, device="cpu")).__name__ == "SRResNet"


def test_bf16_forward_tracks_f32():
    """The bf16 compute path stays within bf16 rounding of the f32 path on
    the same weights (nb=1)."""
    opt = {"network_G": {"nf": NF, "nb": 1, "gc": GC, "num_latent_channels": 1}, "scale": 2}
    g16 = define_G(opt, device="cpu", seed=4)
    g32 = define_G(dict(opt, bf16=False), device="cpu", seed=4)
    lr = torch.rand(1, 8, 6, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = g16(lr), g32(lr)
    assert a.dtype == torch.float32
    assert (a - b).abs().max().item() < 0.05


def test_kaiming_scaled_init():
    """Kaiming-normal fan_in std sqrt(2 / fan_in) times the scale, seeded."""
    g = torch.Generator().manual_seed(0)
    w = kaiming_scaled((64, 96, 3, 3), 0.1, g)
    assert abs(w.std().item() / (0.1 * (2 / (96 * 9)) ** 0.5) - 1) < 0.02
    w2 = kaiming_scaled((64, 96, 3, 3), 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(w, w2)
    a = RRDBNet(nf=NF, nb=1, gc=GC, seed=5).state_dict()
    b = RRDBNet(nf=NF, nb=1, gc=GC, seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
