"""The ported slice end to end: the CEM-wrapped eval forward against JAX's,
the port's independence from JAX, its device rules and its launch counters."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.cem import CEMConf as JCEMConf
from esr_tpu.cem import make_cem as jmake_cem
from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu.ops.color import tensor2img as jtensor2img
from esr_tpu_torch.cem import CEM, CEMConf, make_cem
from esr_tpu_torch.models import define_G, make_eval_forward, state_dict_from_jax
from esr_tpu_torch.ops import tensor2img
from esr_tpu_torch.ops.cuda import kpack_conv, rdb_conv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = {"network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 2, "gc": 4,
                     "num_latent_channels": 1}, "scale": 4, "bf16": False}


def test_eval_forward_matches_jax():
    """make_eval_forward(g, cem) == JAX cem.project(RRDBNet.apply(...)) on a
    non-square batch of 2 with numpy Z, f32, atol 2e-5."""
    model = JRRDBNet(nf=8, nb=2, gc=4, scale=4, num_latent_channels=1)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))
    rng = np.random.default_rng(0)
    lr = rng.random((2, 14, 10, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (2, 14, 10, 1)).astype(np.float32)
    jcem = jmake_cem(JCEMConf(scale=4))
    ref = np.asarray(jcem.project(model.apply(variables, jnp.asarray(lr), jnp.asarray(z)), jnp.asarray(lr)))

    g = define_G(OPT, device="cpu")
    g.load_state_dict(state_dict_from_jax(variables), strict=True)
    cem = make_cem(CEMConf(scale=4), device="cpu")
    out = make_eval_forward(g, cem)(torch.from_numpy(lr), torch.from_numpy(z))
    assert tuple(out.shape) == (2, 56, 40, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    assert (cem.downsample(out) - torch.from_numpy(lr)).abs().max().item() <= 1e-5
    for i in range(2):  # the uint8 answer a server would encode
        np.testing.assert_array_equal(tensor2img(out[i : i + 1]), jtensor2img(ref[i : i + 1]))


def test_port_imports_no_jax_and_no_esr_tpu():
    """Importing every module of esr_tpu_torch pulls in neither jax nor esr_tpu
    (a subprocess: this test process has imported both already); all 78 of its
    modules are walked, so one dropped from the walk is noticed."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import esr_tpu_torch\n"
        "for m in pkgutil.walk_packages(esr_tpu_torch.__path__, 'esr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'esr_tpu') or "
        "m.startswith(('jax.', 'flax.', 'esr_tpu.')))\n"
        "n = sum(1 for m in sys.modules if m.startswith('esr_tpu_torch'))\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 78 else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    """Without device=, define_G / CEM / make_cem ask for CUDA and raise on a
    host without it; device='cpu' is the explicit way to the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        define_G(OPT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cem(CEMConf(scale=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CEM(CEMConf(scale=4))
    assert define_G(OPT, device="cpu").conv_first.weight.device.type == "cpu"


def test_eval_forward_rejects_inputs_on_another_device():
    g = define_G(OPT, device="cpu")
    fwd = make_eval_forward(g, make_cem(CEMConf(scale=4), device="cpu"))
    with pytest.raises(ValueError, match="meta"):
        fwd(torch.empty((1, 4, 4, 3), device="meta"))


def test_launch_counters_stay_zero_on_cpu():
    """The CPU path runs the plain versions: no kernel launch is counted."""
    counters = (rdb_conv.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP)
    for c in counters:
        c.reset()
    g = define_G(OPT, device="cpu")
    fwd = make_eval_forward(g, make_cem(CEMConf(scale=4), device="cpu"))
    out = fwd(torch.rand(1, 6, 5, 3))
    assert tuple(out.shape) == (1, 24, 20, 3)
    assert [c.count for c in counters] == [0, 0, 0]


def test_tensor2img_matches_jax():
    x = np.random.default_rng(3).uniform(-0.2, 1.2, (1, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tensor2img(torch.from_numpy(x)), jtensor2img(x))
    with pytest.raises(ValueError):
        tensor2img(torch.zeros(2, 4, 4, 3))


def test_prepare_kernels_builds_nothing_on_cpu():
    """On the CPU the modules keep no kernel weight layout: every forward runs
    the plain versions from the parameters as they are."""
    g = define_G(OPT, device="cpu")
    lr = torch.rand(1, 6, 5, 3)
    with torch.no_grad():
        before = g(lr)
        g.prepare_kernels()
        after = g(lr)
    assert g.conv_first.kernel_weights is None
    assert g.RRDB_trunk[0].RDB1.kernel_weights is None
    torch.testing.assert_close(after, before, atol=0, rtol=0)
