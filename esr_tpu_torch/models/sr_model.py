"""SRModel: the PSNR-oriented trainer and the eval model (port of
esr_tpu/models/sr_model.py).

The generator comes from ``define_G`` on ``device`` (RRDBNet, with Z at the
first layer or at all layers, or SRResNet); its weights from
``path.pretrain_model_G`` (a torch ``.pth``, see ``BaseModel.load_network``)
when set, else ``define_G``'s seeded ones (seed ``train.manual_seed``, 0 by
default). ``use_cem`` wraps the eval forward in the CEM projection under the
optional top-level ``kernel`` (a separable one takes CEM's matmul mode, a
2-D one its fft mode); a custom kernel also synthesises the training LR.

Training (``is_train``): a pixel loss (l1 / l2 / Charbonnier) on the raw
generator output, Adam with MultiStepLR read at the global step, optional
global-norm clipping; the train step runs the device pipeline (LR synthesis,
augmentation, Z) and then forward and backward. On CUDA the generator's
forward launches the kernels and its backward is the plain recompute of
``ops/cuda/autograd.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.cem.kernels import resolve_kernel
from esr_tpu_torch.data.pipeline import make_train_pipeline
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.models import losses as L
from esr_tpu_torch.models.base_model import (
    Adam,
    BaseModel,
    TrainStep,
    multistep_schedule,
    opt_float,
    step_generator,
    step_keyed,
)
from esr_tpu_torch.models.networks import define_G
from esr_tpu_torch.ops.metrics import psnr_torch
from esr_tpu_torch.parallel.dp import StepParallel
from esr_tpu_torch.utils.profiler import annotate

__all__ = ["SRModel", "make_sr_train_step"]


def make_sr_train_step(g, pipeline, g_opt: Adam, lr_schedule, pixel_criterion: str = "l1",
                       pixel_weight: float = 1.0, par: StepParallel | None = None) -> TrainStep:
    """``train_step(hr_batch, gen) -> metrics``: the pipeline's batch, the
    pixel loss of ``g(LR, Z)`` against HR, one Adam update at learning rate
    ``lr_schedule(g_opt.count)`` (use ``step_keyed`` for the global step).
    ``par``: the parallel axes, as in ``make_gan_train_step``. A
    :class:`~esr_tpu_torch.models.base_model.TrainStep`: the pipeline and
    the learning rate on the host, the rest on the device."""
    params = g_opt.params
    par = par or StepParallel()
    g_fwd = par.g_apply or g

    def prepare(hr_batch, gen: torch.Generator):
        with annotate("train.pipeline"):
            # a pipeline sees the shard only under data parallelism (a test's stand-in takes none)
            batch = pipeline(hr_batch, gen) if par.shard == (0, 1) else pipeline(hr_batch, gen, shard=par.shard)
        with annotate("train.scalars"):
            return None, {"lr": batch["LR"], "hr": batch["HR"], "z": batch.get("Z")}, [
                (g_opt, g_opt.next_scalars(lr_schedule(g_opt.count)))]

    def core(key, lr, hr, z) -> dict:  # noqa: ARG001
        with torch.enable_grad():
            sr = g_fwd(lr, z)
            loss = pixel_weight * par.batch.mean(L.pixel_loss(sr, hr, pixel_criterion))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        g_opt.step(par.sync_g(params, list(grads)), None, par.sync_g.sq_sum)
        return {"l_pix": loss.detach(), "psnr": psnr_torch(sr.detach(), hr, quantize=False, mean=par.batch.mean)}

    return TrainStep(prepare, core)


def _pipeline(opt: dict, scale: int, nz: int, lr_synth):
    """The train pipeline from the options: augment flags from the train
    dataset block (the train block's as a fallback)."""
    train_opt = opt.get("train") or {}
    ds = (opt.get("datasets") or {}).get("train") or {}
    return make_train_pipeline(
        scale=scale,
        use_flip=bool(ds.get("use_flip", train_opt.get("use_flip", True))),
        use_rot=bool(ds.get("use_rot", train_opt.get("use_rot", True))),
        num_latent_channels=nz,
        downsample_fn=lr_synth.downsample if lr_synth is not None else None,
    )


class SRModel(BaseModel):
    def __init__(self, opt: dict, device: str | torch.device = "cuda"):
        super().__init__(opt)
        self.device = resolve_device(device)
        self.scale = int(opt.get("scale") or 4)
        train_opt = opt.get("train") or {}
        self.seed = int(train_opt.get("manual_seed") or 0)
        self.g_module = define_G(opt, device=self.device, seed=self.seed)
        self.nz = self.g_module.num_latent_channels
        self._kernel = resolve_kernel(opt.get("kernel"))
        self.cem = (
            make_cem(CEMConf(scale=self.scale, kernel=self._kernel), device=self.device)
            if opt.get("use_cem") else None
        )
        # a custom kernel defines the training LR too (one operator with CEM's)
        self._lr_synth = (
            (self.cem or make_cem(CEMConf(scale=self.scale, kernel=self._kernel), device=self.device))
            if self._kernel is not None else None
        )
        pretrained = (opt.get("path") or {}).get("pretrain_model_G")
        if pretrained:
            self.load_network(pretrained)
        self._paired_lr = bool(((opt.get("datasets") or {}).get("train") or {}).get("dataroot_LR"))
        self._par = StepParallel()
        if self.is_train:
            self._par = self._train_parallel()
            self._init_training(train_opt)
        self._forward = None if self.is_train else self._make_forward()
        self._data: dict = {}

    def _init_training(self, train_opt: dict) -> None:
        sched = multistep_schedule(opt_float(train_opt, "lr_G", 2e-4), train_opt.get("lr_steps") or [],
                                   opt_float(train_opt, "lr_gamma", 0.5))
        self.schedulers["G"] = sched
        clip = train_opt.get("grad_clip")
        self.g_opt = Adam(self.g_module.parameters(), opt_float(train_opt, "beta1_G", 0.9),
                          grad_clip=float(clip) if clip else None)
        self._train_step = make_sr_train_step(
            self.g_module, _pipeline(self.opt, self.scale, self.nz, self._lr_synth), self.g_opt,
            step_keyed(sched), train_opt.get("pixel_criterion") or "l1",
            opt_float(train_opt, "pixel_weight", 1.0), par=self._par,
        )
        self._rng_seed = self.seed + 1
        self._step_graphs = self._make_step_graphs("SR train step")

    def _prepare_step(self, batch, step: int):
        return self._train_step.prepare(batch, step_generator(self._rng_seed, step))

    def optimize_parameters(self, step: int) -> None:
        """Train step ``step`` on the fed batch (on CUDA in one process, a
        CUDA graph's replay: ``BaseModel._run_steps``); the span
        ``train.step``, its identifier the step."""
        self.step = step
        with annotate("train.step", step):
            self._losses = self._run_steps([self._prepare_step(self._prep_batch(self._data), step)])

    def optimize_parameters_chunk(self, first_step: int, chunk: dict) -> None:
        """Train steps ``first_step`` .. ``first_step + k - 1`` on the k
        loader batches of ``chunk`` (``train.stack_chunk``: arrays stacked on
        a leading step axis): every step's pipeline and draws first, then the
        k device parts back to back (on CUDA, k replays of the step's graph
        with the step scalars uploaded once). The trajectory of k
        ``optimize_parameters`` calls; ``get_current_losses`` then reports the
        last step's metrics. One ``train.step`` span, its identifier the first step."""
        with annotate("train.step", first_step):
            batches = self._prep_batch(chunk)
            k = int(np.asarray(chunk["HR"]).shape[0])
            pick = ((lambda i: {n: v[i] for n, v in batches.items()}) if isinstance(batches, dict)
                    else batches.__getitem__)
            self._losses = self._run_steps([self._prepare_step(pick(i), first_step + i) for i in range(k)])
        self.step = first_step + k - 1

    def test(self, z: np.ndarray | torch.Tensor | None = None) -> None:
        """Forward the fed LR (HWC or NHWC) with Z (zeros when None); SR and
        LR stay on the device until a visuals getter fetches them. A trainer
        builds the eval forward (and the kernels' weight layouts) from the
        weights as they are now, and drops the layouts after."""
        lr = torch.as_tensor(np.asarray(self._data["LR"], np.float32), device=self.device)
        if lr.ndim == 3:
            lr = lr[None]
        zz = None
        if self.nz:
            if z is None:
                zz = lr.new_zeros(lr.shape[:-1] + (self.nz,))
            else:
                zz = torch.as_tensor(z, dtype=torch.float32, device=self.device)
                if zz.ndim == 3:
                    zz = zz[None]
        if self.is_train:  # eager: the weights change before the next validation
            sr = self._make_forward(graphs=False)(lr, zz)
            self.g_module.release_kernels()
        else:
            sr = self._forward(lr, zz)
        self._visuals = {"SR": sr[0], "LR": lr[0]}
        if self._data.get("HR") is not None:
            hr = np.asarray(self._data["HR"])
            self._visuals["HR"] = hr[0] if hr.ndim == 4 else hr

    def save(self, iter_label) -> None:
        self.save_network(self.g_module, "G", iter_label)

    def data_shard(self) -> tuple[int, int]:
        """This rank's (index, count) of the train batch's rows (data parallelism)."""
        return self._par.shard

    def save_training(self, epoch: int, iter_step: int) -> None:
        self.save_training_state(epoch, iter_step, {"G": {"net": self._full_state(self.g_module),
                                                          "opt": self._opt_state(self.g_module, self.g_opt)}})

    def resume_training(self, path: str) -> tuple[int, int]:
        state = self.restore_training_state(path)
        self._drop_step_graphs()
        self._load_state(self.g_module, state["G"]["net"])
        self._load_opt_state(self.g_module, self.g_opt, state["G"]["opt"])
        self.step = int(state["iter"])
        return int(state["epoch"]), int(state["iter"])
