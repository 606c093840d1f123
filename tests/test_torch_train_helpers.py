"""Shared set-up of the training parity tests (tests/test_torch_train*.py):
one tiny explorable GAN configuration built on both sides with the same
weights, and a fixed batch made with numpy.

Size: nf 8, nb 1, gc 4, one Z channel, CEM, D nf 8 at HR 32 (a 1 x 1 final
map), the full-width VGG19 (its widths are fixed) to conv5_4, f32 everywhere
(``"bf16": false``), batch 2. The JAX weights are its modules' own init,
carried to the port by the bridges.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from esr_tpu.cem import CEMConf, make_cem as jmake_cem
from esr_tpu.models import losses as JL
from esr_tpu.models.networks import define_D as jdefine_D
from esr_tpu.models.networks import define_F as jdefine_F
from esr_tpu.models.networks import define_G as jdefine_G
from esr_tpu.ops.resize import imresize_np as jimresize_np
from esr_tpu_torch.models import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
    vgg_state_dict_from_jax,
)
from esr_tpu_torch.models.base_model import Adam

N, HR = 2, 32


def gan_opt(root: str, **train) -> dict:
    opt = {
        "name": "train_parity", "model": "srragan", "scale": 4, "use_cem": True, "bf16": False,
        "datasets": {"train": {"name": "syn", "mode": "SYNTHETIC", "n_images": 4, "image_size": 48,
                               "batch_size": N, "HR_size": HR}},
        "path": {"root": root},
        "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1,
                      "latent_input": "first_layer", "fold": 1},
        "network_D": {"which_model_D": "discriminator_vgg_128", "nf": 8, "norm_type": "batch"},
        "train": {"lr_G": 1e-4, "lr_D": 1e-4, "lr_steps": [2], "lr_gamma": 0.5, "pixel_weight": 0.01,
                  "feature_weight": 1.0, "gan_weight": 0.005, "range_weight": 1.0, "map_weight": 1.0,
                  "manual_seed": 0, "watchdog": False},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 3},
    }
    opt["train"].update(train)
    return opt


def fixed_batch(seed: int = 0, nz: int = 1) -> dict:
    """HR in [0, 1], its bicubic LR, a Z map in [-1, 1]: numpy, f32."""
    rng = np.random.default_rng(seed)
    hr = rng.random((N, HR, HR, 3)).astype(np.float32)
    out = {"HR": hr, "LR": np.stack([jimresize_np(h, scale=0.25) for h in hr]).astype(np.float32)}
    if nz:
        out["Z"] = rng.uniform(-1, 1, (N, HR // 4, HR // 4, nz)).astype(np.float32)
    return out


class JaxNets:
    """The JAX modules of ``opt`` with their init (seeds as SRRaGANModel's)."""

    def __init__(self, opt: dict):
        self.g = jdefine_G(opt)
        self.d = jdefine_D(opt)
        self.f = jdefine_F(opt)
        self.cem = jmake_cem(CEMConf(scale=4))
        lr0 = jnp.zeros((1, HR // 4, HR // 4, 3))
        z0 = jnp.zeros((1, HR // 4, HR // 4, 1)) if self.g.num_latent_channels else None
        self.g_params = self.g.init(jax.random.PRNGKey(0), lr0, z0)["params"]
        self.d_vars = self.d.init(jax.random.PRNGKey(1), jnp.zeros((1, HR, HR, 3)), train=False)
        self.f_vars = self.f.init(jax.random.PRNGKey(2), jnp.zeros((1, HR, HR, 3)))

    def load_port(self, model) -> None:
        """Carry the weights into a port model by the bridges."""
        host = jax.device_get
        model.g_module.load_state_dict(state_dict_from_jax(host(self.g_params)), strict=True)
        if hasattr(model, "d_module"):
            model.d_module.load_state_dict(discriminator_state_dict_from_jax(host(self.d_vars)), strict=True)
            model.f_module.load_torchvision(vgg_state_dict_from_jax(host(self.f_vars)))


def g_loss_jax(nets: JaxNets, cfg: dict, g_params, d_vars, batch) -> tuple:
    """G's loss composed as ``make_gan_train_step``'s ``g_loss_fn`` composes it
    (``g_module.apply`` + ``cem.project`` + the losses), on a fixed batch;
    returns (loss, sr)."""
    lr, z = batch["LR"], batch.get("Z")
    hr = nets.cem.enforce_dt_on_image_pair(lr, batch["HR"])
    sr = nets.cem.project(nets.g.apply({"params": g_params}, lr, z), lr)
    gan_type, rel = cfg.get("gan_type") or "vanilla", bool(cfg.get("relativistic", True))
    loss = cfg["pixel_weight"] * JL.pixel_loss(sr, hr, "l1")
    loss += cfg["feature_weight"] * JL.perceptual_l1(nets.f.apply(nets.f_vars, jnp.clip(sr, 0.0, 1.0)),
                                                     nets.f.apply(nets.f_vars, hr))
    if cfg["gan_weight"]:
        logits, _ = nets.d.apply(d_vars, jnp.concatenate([hr, sr], 0), train=True, mutable=["batch_stats"])
        d_real, d_fake = jnp.split(logits, 2, axis=0)
        loss += cfg["gan_weight"] * JL.ragan_g_loss(d_real, d_fake, gan_type, rel)
    loss += cfg["range_weight"] * JL.range_loss(sr)
    if z is not None:
        loss += cfg["map_weight"] * JL.map_loss(sr, hr, z)
    return loss, sr


def d_loss_jax(nets: JaxNets, cfg: dict, d_params, d_vars, hr, fake) -> jnp.ndarray:
    """D's loss as ``make_gan_train_step``'s ``d_loss_fn`` (no penalty)."""
    logits, _ = nets.d.apply({**d_vars, "params": d_params}, jnp.concatenate([hr, fake], 0), train=True,
                             mutable=["batch_stats"])
    d_real, d_fake = jnp.split(logits, 2, axis=0)
    return JL.ragan_d_loss(d_real, d_fake, cfg.get("gan_type") or "vanilla", bool(cfg.get("relativistic", True)))


class RecordingAdam(Adam):
    """The port's Adam, keeping the gradients of every ``step`` call."""

    def __init__(self, base: Adam):
        super().__init__(base.params, base.b1, base.b2, base.eps, base.grad_clip)
        self.grads: list[list[torch.Tensor]] = []

    def step(self, grads: list, lr: float) -> None:
        self.grads.append([g.detach().clone() for g in grads])
        super().step(grads, lr)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def deep(opt: dict) -> dict:
    return copy.deepcopy(opt)


def run_gan(opt: dict, steps: int, batch_np: dict) -> dict:
    """``steps`` GAN steps of both trainers from the same weights on the same
    batch (the WGAN-GP weights of each step as JAX draws them, handed to the
    port): JAX train states before and after each step, the metrics of
    both, the port model with recording optimisers, D's running statistics
    after each port step."""
    from esr_tpu.models.base_model import TrainState, make_adam, multistep_schedule, step_keyed as jstep_keyed
    from esr_tpu.models.base_model import unit_schedule
    from esr_tpu.models.srragan_model import make_gan_train_step as jmake_gan_train_step
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.models.base_model import step_keyed
    from esr_tpu_torch.models.srragan_model import make_gan_train_step
    from esr_tpu_torch.options import parse

    cfg = opt["train"]
    nets = JaxNets(opt)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    steps_, gamma = cfg.get("lr_steps") or [], cfg.get("lr_gamma", 0.5)
    g_sched = multistep_schedule(cfg["lr_G"], steps_, gamma)
    d_sched = multistep_schedule(cfg["lr_D"], steps_, gamma)
    clip = cfg.get("grad_clip")
    g_state = TrainState.create(apply_fn=nets.g.apply, params=nets.g_params,
                                tx=make_adam(unit_schedule, grad_clip=clip))
    d_state = TrainState.create(apply_fn=nets.d.apply, params=nets.d_vars["params"],
                                tx=make_adam(jstep_keyed(d_sched), grad_clip=clip),
                                batch_stats=nets.d_vars["batch_stats"])
    jstep = jax.jit(jmake_gan_train_step(nets.g, nets.d, nets.f, nets.f_vars, nets.cem, lambda h, r: jb, cfg,
                                         g_lr_schedule=g_sched))
    states, jmetrics, eps = [(g_state, d_state)], [], []
    for s in range(1, steps + 1):
        rng = jax.random.PRNGKey(s)
        eps.append(np.asarray(jax.random.uniform(jax.random.split(rng)[1], (N, 1, 1, 1))))
        g_state, d_state, m = jstep(g_state, d_state, jnp.zeros(()), rng, jnp.int32(s))
        states.append((g_state, d_state))
        jmetrics.append({k: float(v) for k, v in jax.device_get(m).items()})

    model = create_model(parse(deep(opt), is_train=True), device="cpu")
    nets.load_port(model)
    g_opt, d_opt = RecordingAdam(model.g_opt), RecordingAdam(model.d_opt)
    tb = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    pstep = make_gan_train_step(model.g_module, model.d_module, model.f_module, model.cem, lambda h, g: tb, cfg,
                                g_opt, d_opt, model.schedulers["G"], step_keyed(model.schedulers["D"]))
    pmetrics, pstats = [], []
    for s in range(1, steps + 1):
        m = pstep(None, torch.Generator(), s, gp_eps=torch.from_numpy(eps[s - 1]))
        pmetrics.append({k: float(v) for k, v in m.items()})
        pstats.append({k: v.clone() for k, v in model.d_module.state_dict().items() if "running" in k})
    return {"nets": nets, "states": states, "jmetrics": jmetrics, "pmetrics": pmetrics, "pstats": pstats,
            "model": model, "g_opt": g_opt, "d_opt": d_opt}


def d_state_dict(d_state) -> dict:
    return discriminator_state_dict_from_jax(
        {"params": jax.device_get(d_state.params), "batch_stats": jax.device_get(d_state.batch_stats)})


# zero in exact arithmetic, float noise in both frameworks (test_torch_train.py)
NOISE_GRADS = {"conv_last.bias", "linear1.bias", "linear2.bias"}


def check_metrics(jmetrics: list, pmetrics: list) -> None:
    """Each step's metrics: the same keys, within 1e-4 relative at step 1 and
    1e-3 after (test_torch_train.py gives the reasons). D_real and D_fake are
    mean logits, O(1) in scale but free to cross 0: they are held to the same
    numbers absolute."""
    for i, (jm, pm) in enumerate(zip(jmetrics, pmetrics, strict=True)):
        assert set(pm) == set(jm), (set(pm) ^ set(jm))
        tol = 1e-4 if i == 0 else 1e-3
        for k, v in jm.items():
            scale = 1.0 if k in ("D_real", "D_fake") else abs(v)
            assert abs(pm[k] - v) <= tol * scale + 1e-9, (i + 1, k, pm[k], v)


def check_param_change(before: dict, after: dict, port: dict, lr: float, steps: int) -> None:
    """Each tensor's change against JAX's. Adam divides a gradient element by
    its own magnitude, so an element whose gradient is float noise (zero in
    exact arithmetic, or cancelled to noise) steps by up to the learning rate
    in a random direction in either framework. So: every element within
    Adam's bound (one learning rate per step, either way); all but one
    element in a thousand (at least one per tensor) within 1e-5 (a tenth of
    a step at lr 1e-4); the tensors of float-noise gradients (NOISE_GRADS)
    only within the bound."""
    for k, v in port.items():
        if "running" in k or "num_batches" in k:
            continue
        diff = np.abs((v.numpy() - before[k].numpy()) - (after[k].numpy() - before[k].numpy()))
        assert float(diff.max()) <= 2 * steps * lr, (k, float(diff.max()))
        if k not in NOISE_GRADS:
            n_off = int((diff > 1e-5).sum())
            assert n_off <= max(1, diff.size // 1000), (k, n_off, diff.size, float(diff.max()))


def check_gan_params(run: dict, steps: int) -> None:
    """G and D after ``steps`` steps against JAX (``check_param_change``)."""
    (g0, d0), (g1, d1) = run["states"][0], run["states"][steps]
    model, cfg = run["model"], run["model"].opt["train"]
    check_param_change(state_dict_from_jax(jax.device_get(g0.params)),
                       state_dict_from_jax(jax.device_get(g1.params)), model.g_module.state_dict(),
                       cfg["lr_G"], steps)
    check_param_change(d_state_dict(d0), d_state_dict(d1), model.d_module.state_dict(), cfg["lr_D"], steps)
