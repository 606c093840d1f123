"""SRRaGANModel: the ESRGAN / explorable GAN trainer (port of
esr_tpu/models/srragan_model.py). At eval time it is its generator behind
the CEM projection, as ``SRModel`` is.

The train step keeps the JAX step's semantics:

- the generator runs once per step: CEM-projected (``use_cem``) and
  Z-conditioned; its output, detached, feeds D's update;
- the ground truth is projected to consistency with its LR first
  (``cem.enforce_dt_on_image_pair``), so consistency is no real/fake cue;
- losses: pixel (optional) + VGG-feature L1 + relativistic-average GAN
  (standard GAN with ``relativistic: false``) + range + map;
- G updates first, against the pre-update D, when ``step % D_update_ratio ==
  0 and step > D_init_iters``, at the learning rate of the global step; a
  skipped update leaves Adam's state as it is. D updates every step;
- real and fake go through D as one doubled batch; BatchNorm's running
  statistics change only in D's own update; ``gan_weight: 0`` skips D in
  G's loss; ``wgan-gp`` adds the gradient penalty (at D's pre-step
  statistics).

On CUDA the generator's forward launches the kernels (``rdb5c``, ``conv3x3``
in both modes) and its backward is the plain recompute of
``ops/cuda/autograd.py``. D and VGG19 are PyTorch convs (the JAX package's
are XLA convs).
"""

from __future__ import annotations

import logging

import torch

from esr_tpu_torch.models import losses as L
from esr_tpu_torch.models.architecture import FlaxBatchNorm2d
from esr_tpu_torch.models.base_model import (
    Adam,
    TrainStep,
    multistep_schedule,
    opt_float,
    step_generator,
    step_keyed,
)
from esr_tpu_torch.models.networks import define_D, define_F
from esr_tpu_torch.models.sr_model import SRModel, _pipeline
from esr_tpu_torch.ops.metrics import psnr_torch
from esr_tpu_torch.parallel.dp import StepParallel

__all__ = ["SRRaGANModel", "make_gan_train_step"]


def make_gan_train_step(g, d, f, cem, pipeline, cfg: dict, g_opt: Adam, d_opt: Adam, g_lr_schedule,
                        d_lr_schedule, par: StepParallel | None = None) -> TrainStep:
    """``train_step(hr_batch, gen, step, gp_eps=None) -> metrics`` (see the
    module docstring). G's learning rate is ``g_lr_schedule(step)``; D's
    ``d_lr_schedule(d_opt.count)`` (``step_keyed`` for the global step).
    ``gp_eps``: the WGAN-GP interpolation weights (N, 1, 1, 1); drawn from
    ``gen`` after the pipeline's draws when None.

    ``par`` (the parallel axes, ``parallel/dp.py``): ``hr_batch`` is this
    rank's rows of the global batch, G runs through ``par.g_apply``, every
    batch mean and batch statistic (D's BatchNorm, RaGAN's mean logits, the
    logged metrics) is the global batch's, the draws are the global batch's
    rows, and the gradients are reduced before Adam (and its clip): the step
    computes what one process computes on the global batch.

    A :class:`~esr_tpu_torch.models.base_model.TrainStep`: the pipeline, the
    WGAN-GP draw, ``do_g`` (the key: one graph for each value) and the
    learning rates on the host; the CEM projection of HR, both losses, their
    gradients and both updates on the device."""
    par = par or StepParallel()
    g_fwd = par.g_apply or g
    mean, stat_mean = par.batch.mean, par.batch.stat_mean
    for m in d.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.stat_mean = stat_mean
    gan_type = cfg.get("gan_type") or "vanilla"
    relativistic = bool(cfg.get("relativistic", True))
    w_gp = opt_float(cfg, "gp_weight", 10.0 if gan_type == "wgan-gp" else 0.0)
    w_pix = opt_float(cfg, "pixel_weight", 0.0)
    w_feat = opt_float(cfg, "feature_weight", 0.0)
    w_gan = opt_float(cfg, "gan_weight", 0.005)
    w_range = opt_float(cfg, "range_weight", 0.0)
    w_map = opt_float(cfg, "map_weight", 0.0)
    pix_kind = cfg.get("pixel_criterion") or "l1"
    d_ratio = int(cfg.get("D_update_ratio") or 1)
    d_init = int(cfg.get("D_init_iters") or 0)
    g_params, d_params = g_opt.params, d_opt.params

    def g_loss(lr, hr, z):
        sr = g_fwd(lr, z)
        if cem is not None:
            sr = cem.project(sr, lr)
        aux = {}
        if w_pix:
            aux["l_g_pix"] = w_pix * mean(L.pixel_loss(sr, hr, pix_kind))
        if w_feat:
            with torch.no_grad():
                feat_hr = f(hr)
            aux["l_g_fea"] = w_feat * mean(L.perceptual_l1(f(sr.clamp(0.0, 1.0)), feat_hr))
        if w_gan:
            d_real, d_fake = d(torch.cat([hr, sr]), train=True).chunk(2)
            aux["l_g_gan"] = w_gan * L.ragan_g_loss(d_real, d_fake, gan_type, relativistic, mean, stat_mean)
        else:  # the gan_weight: 0 ablation skips D
            aux["l_g_gan"] = sr.new_zeros(())
        if w_range:
            aux["l_g_range"] = w_range * mean(L.range_loss(sr))
        if w_map and z is not None:
            aux["l_g_map"] = w_map * mean(L.map_loss(sr, hr, z))
        loss = sum(aux.values())
        aux["psnr"] = psnr_torch(sr.detach(), hr, quantize=False, mean=mean)
        return loss, aux, sr

    def prepare(hr_batch, gen: torch.Generator, step: int, gp_eps=None):
        # a pipeline sees the shard only under data parallelism (a test's stand-in takes none)
        batch = pipeline(hr_batch, gen) if par.shard == (0, 1) else pipeline(hr_batch, gen, shard=par.shard)
        if w_gp and gp_eps is None:
            i, n_shards = par.shard
            n = batch["HR"].shape[0]
            gp_eps = torch.rand((n * n_shards, 1, 1, 1), generator=gen)[i * n : (i + 1) * n]
        # G first, against the pre-update D (steps are 1-based; strict >)
        do_g = step % d_ratio == 0 and step > d_init
        rows = [(g_opt, g_opt.next_scalars(g_lr_schedule(step)))] if do_g else []
        rows.append((d_opt, d_opt.next_scalars(d_lr_schedule(d_opt.count))))
        inputs = {"lr": batch["LR"], "hr": batch["HR"], "z": batch.get("Z"), "gp_eps": gp_eps if w_gp else None}
        return do_g, inputs, rows

    def core(do_g: bool, lr, hr, z, gp_eps) -> dict:
        if cem is not None:
            hr = cem.enforce_dt_on_image_pair(lr, hr)
        with torch.set_grad_enabled(do_g):
            l_g, aux, fake = g_loss(lr, hr, z)
            if do_g:
                grads = torch.autograd.grad(l_g, g_params, allow_unused=True)
        if do_g:
            g_opt.step(par.sync_g(g_params, list(grads)), None, par.sync_g.sq_sum)
        fake = fake.detach()

        # D every step; the penalty reads D at its pre-step running statistics
        with torch.enable_grad():
            l_d = 0.0
            if w_gp:
                l_d = w_gp * mean(L.gradient_penalty(lambda x: d(x, train=False), hr, fake, gp_eps.to(hr.device)))
            d_real, d_fake = d(torch.cat([hr, fake]), train=True, update_stats=True).chunk(2)
            l_d = L.ragan_d_loss(d_real, d_fake, gan_type, relativistic, mean, stat_mean) + l_d
            d_grads = torch.autograd.grad(l_d, d_params, allow_unused=True)
        d_opt.step(par.sync_d(d_params, list(d_grads)), None, par.sync_d.sq_sum)
        metrics = {"l_d": l_d.detach(), "l_g": l_g.detach(), "D_real": mean(d_real.detach()),
                   "D_fake": mean(d_fake.detach())}
        metrics.update({k: v.detach() for k, v in aux.items()})
        return metrics

    return TrainStep(prepare, core)


class SRRaGANModel(SRModel):
    def _init_training(self, train_opt: dict) -> None:
        opt = self.opt
        self.d_module = define_D(opt, device=self.device, seed=self.seed + 1)
        self.f_module = define_F(opt, device=self.device, seed=self.seed + 2)
        paths = opt.get("path") or {}
        if paths.get("pretrain_model_F"):
            self.f_module.load_torchvision(torch.load(paths["pretrain_model_F"], map_location=self.device,
                                                      weights_only=True))
        if paths.get("pretrain_model_D"):
            self._load_module(self.d_module, paths["pretrain_model_D"])
        steps, gamma = train_opt.get("lr_steps") or [], opt_float(train_opt, "lr_gamma", 0.5)
        g_sched = multistep_schedule(opt_float(train_opt, "lr_G", 1e-4), steps, gamma)
        d_sched = multistep_schedule(opt_float(train_opt, "lr_D", 1e-4), steps, gamma)
        self.schedulers = {"G": g_sched, "D": d_sched}
        clip = train_opt.get("grad_clip")
        clip = float(clip) if clip else None
        self.g_opt = Adam(self.g_module.parameters(), opt_float(train_opt, "beta1_G", 0.9), grad_clip=clip)
        self.d_opt = Adam(self.d_module.parameters(), opt_float(train_opt, "beta1_D", 0.9), grad_clip=clip)
        self._train_step = make_gan_train_step(
            self.g_module, self.d_module, self.f_module, self.cem,
            _pipeline(opt, self.scale, self.nz, self._lr_synth), train_opt, self.g_opt, self.d_opt,
            g_lr_schedule=g_sched, d_lr_schedule=step_keyed(d_sched), par=self._par,
        )
        self._rng_seed = self.seed + 3
        self._step_graphs = self._make_step_graphs("GAN train step")
        lg = logging.getLogger("base")
        for name, net in (("G", self.g_module), ("D", self.d_module), ("F", self.f_module)):
            n = sum(p.numel() for p in net.parameters())
            lg.info(f"Network {name}: {type(net).__name__} with {n:,d} parameters")

    def _prepare_step(self, batch, step: int):
        return self._train_step.prepare(batch, step_generator(self._rng_seed, step), step)

    def save(self, iter_label) -> None:
        self.save_network(self.g_module, "G", iter_label)
        if self.is_train:
            self.save_network(self.d_module, "D", iter_label)

    def save_training(self, epoch: int, iter_step: int) -> None:
        self.save_training_state(epoch, iter_step, {
            key: {"net": self._full_state(net), "opt": self._opt_state(net, opt_)}
            for key, net, opt_ in (("G", self.g_module, self.g_opt), ("D", self.d_module, self.d_opt))
        })

    def resume_training(self, path: str) -> tuple[int, int]:
        state = self.restore_training_state(path)
        self._drop_step_graphs()
        for net, opt_, key in ((self.g_module, self.g_opt, "G"), (self.d_module, self.d_opt, "D")):
            self._load_state(net, state[key]["net"])
            self._load_opt_state(net, opt_, state[key]["opt"])
        self.step = int(state["iter"])
        return int(state["epoch"]), int(state["iter"])
