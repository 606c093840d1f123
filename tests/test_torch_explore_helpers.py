"""Shared set-up of the exploration parity tests
(tests/test_torch_explore_*.py): one small explorable generator built on both
sides with the same weights.

Size: RRDBNet nf 16, nb 2, gc 8, x4, one Z channel, CEM in matmul mode, f32
on both sides, LR 16 x 16 made with numpy. The JAX weights are its module's
own init, carried to the port by ``state_dict_from_jax``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from esr_tpu.cem import CEMConf as JCEMConf
from esr_tpu.cem import make_cem as jmake_cem
from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.models import define_G, state_dict_from_jax

OPT = {"network_G": {"nf": 16, "nb": 2, "gc": 8, "num_latent_channels": 1}, "scale": 4, "bf16": False}
LR = 16


class Setup:
    """Both generators and CEMs on the same weights; ``lr`` (1, 16, 16, 3)."""

    def __init__(self):
        model = JRRDBNet(nf=16, nb=2, gc=8, scale=4, num_latent_channels=1)
        self.lr = np.random.default_rng(0).random((1, LR, LR, 3)).astype(np.float32)
        variables = model.init(jax.random.PRNGKey(0), jnp.asarray(self.lr), jnp.zeros((1, LR, LR, 1)))
        self.params = variables["params"]
        self.jcem = jmake_cem(JCEMConf(scale=4))

        def jforward(p, lr, z):
            return self.jcem.project(model.apply({"params": p}, lr, z), lr)

        self.jforward = jforward
        self.state = state_dict_from_jax(variables)
        self.cem = make_cem(CEMConf(scale=4), device="cpu")

    def g(self):
        """A fresh port generator on the JAX weights (the session freezes it)."""
        g = define_G(OPT, device="cpu")
        g.load_state_dict(self.state, strict=True)
        return g

    def port_forward(self):
        g = self.g().requires_grad_(False)
        return lambda lr, z: self.cem.project(g(lr, z), lr)


def z_close(z_port, z_jax, grad_jax, atol=1e-4) -> None:
    """Z within ``atol`` of JAX's, except on elements whose JAX gradient at the
    start is below 1e-6 of its largest: Adam turns such float-noise gradients
    into full-LR steps whose sign is noise, in either package."""
    z_port, z_jax, grad_jax = (np.asarray(a) for a in (z_port, z_jax, grad_jax))
    live = np.abs(grad_jax) >= 1e-6 * np.abs(grad_jax).max()
    np.testing.assert_allclose(z_port[live], z_jax[live], atol=atol, rtol=0)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
