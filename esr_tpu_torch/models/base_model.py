"""The eval forward and the models' shared surface (port of the single-device
parts of esr_tpu/models/base_model.py).

``make_eval_forward``: the generator, then the exact CEM projection.
``BaseModel``: what the CLIs and the export path call on a model —
``_make_forward`` (the options' wrappers around ``make_eval_forward``),
``load_network``, the visuals getters and the training surface: losses,
learning rate, and checkpoints as torch files (``<iter>_<net>.pth`` network
state_dicts, ``<iter>.state`` training states; the JAX package writes orbax
directories, which the port cannot read).

The optimiser is optax's: ``multistep_schedule`` is its piecewise-constant
MultiStepLR (a milestone m applies from count m on), ``step_keyed`` reads it
at the 1-based global step for an optimiser that updates every step, and ``Adam``
computes ``m_hat / (sqrt(v_hat) + eps)`` after an optional global-norm clip
written to ``optax.clip_by_global_norm``'s formula.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from torch import nn

from esr_tpu_torch.models.architecture import RRDBNet
from esr_tpu_torch.ops.color import tensor2img, to_uint8
from esr_tpu_torch.ops.ensemble import make_self_ensemble

__all__ = [
    "Adam",
    "BaseModel",
    "make_eval_forward",
    "multistep_schedule",
    "opt_float",
    "step_generator",
    "step_keyed",
]

_PARALLEL = ("multi-device eval ({}) is not ported yet (ROADMAP.md Queue 1 item 10, the parallel "
             "axes); the port evaluates on one device")
_PARALLEL_TRAIN = ("multi-device training ({}) is not ported yet (ROADMAP.md Queue 1 item 10, the "
                   "parallel axes); the port trains on one device")


def opt_float(cfg: dict | None, key: str, default: float) -> float:
    """Numeric option that honours an explicit 0 (``gan_weight: 0`` is an
    ablation, not the default): only a missing or None key takes ``default``."""
    v = (cfg or {}).get(key)
    return float(default if v is None else v)


def multistep_schedule(lr: float, steps, gamma: float = 0.5):
    """MultiStepLR as optax's ``piecewise_constant_schedule``: ``lr`` times
    ``gamma`` for every milestone at or below ``count``."""
    bounds = sorted(int(s) for s in (steps or []))

    def schedule(count: int) -> float:
        return float(lr * gamma ** sum(count >= b for b in bounds))

    return schedule


def step_keyed(schedule):
    """A count-keyed schedule read at the 1-based global step, for an
    optimiser that updates every step: the k-th update reads ``schedule(k)``
    (optax reads the k-th update at count k - 1)."""
    return lambda count: schedule(count + 1)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one train step's random numbers (augment codes,
    Z, the WGAN-GP weights): a pure function of (seed, step), so a resumed
    run draws what the original drew."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class Adam:
    """optax ``adam`` (b1, b2, eps 1e-8), after ``clip_by_global_norm`` when
    ``grad_clip`` is set, over a list of parameters. ``step(grads, lr)``
    applies one update with learning rate ``lr``; ``count`` is the number of
    updates applied. Skipping ``step`` leaves the moments and the count as
    they are (a gated update)."""

    def __init__(self, params, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float | None = None):
        self.params = [p for p in params]
        self.b1, self.b2, self.eps, self.grad_clip = b1, b2, eps, grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def clip(self, grads: list) -> list:
        """optax: ``g`` if the global norm is below ``grad_clip``, else
        ``g / norm * grad_clip`` (no epsilon, unlike ``clip_grad_norm_``)."""
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        return [g * scale.to(g.dtype) for g in grads]

    @torch.no_grad()
    def step(self, grads: list, lr: float) -> None:
        if self.grad_clip:
            grads = self.clip(grads)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, 1 - self.b2**self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, 1 - self.b1**self.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            for d, v in zip(dst, state[key], strict=True):
                d.copy_(v)


def make_eval_forward(g: RRDBNet, cem=None, self_ensemble: bool = False):
    """``fwd(lr, z=None) = cem.project(g(lr, z), lr)`` (raw ``g`` when ``cem``
    is None), without autograd. With ``self_ensemble`` the generator call is
    the x8 dihedral mean (``ops/ensemble.py``: two batched calls), projected
    once. lr: (N, H, W, 3) and z: (N, H, W, nz) on the generator's device;
    the answer is (N, sH, sW, 3) f32. The kernels' weight layout is built
    here, once: make a new forward after changing g's weights."""
    device = next(g.parameters()).device
    g.prepare_kernels()
    apply_raw = make_self_ensemble(g) if self_ensemble else g

    @torch.no_grad()
    def fwd(lr: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        for name, t in (("lr", lr), ("z", z)):
            if t is not None and t.device != device:
                raise ValueError(f"{name} is on {t.device}, the generator on {device}")
        raw = apply_raw(lr, z)
        return cem.project(raw, lr) if cem is not None else raw

    return fwd


class BaseModel:
    """Eval surface shared by the SR models. Subclasses set ``g_module``,
    ``cem``, ``nz``, ``scale`` and ``device``."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.is_train = bool(opt.get("is_train"))
        self._visuals: dict = {}
        self._losses: dict = {}
        self.schedulers: dict = {}  # name -> schedule (logging)
        self.step = 0

    def _refuse_parallel_training(self) -> None:
        """The JAX package's multi-device trainers raise here (one device)."""
        for key in ("train_tp", "train_pp", "train_spatial"):
            if self.opt.get(key) or (self.opt.get("train") or {}).get(key):
                raise NotImplementedError(_PARALLEL_TRAIN.format(key))
        if self.opt.get("dist") and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError(_PARALLEL_TRAIN.format("dist (data parallel)"))

    def _make_forward(self):
        """The eval forward of ``make_eval_forward`` with the options'
        wrappers: ``self_ensemble`` outermost around the generator, then CEM.
        The JAX package's multi-device forwards (``eval_tp``, ``eval_pp``,
        ``eval_spatial``, ``dist_eval`` over several devices) raise
        ``NotImplementedError``. ``network_G.fold`` > 1 runs the unfolded
        forward: its spatial-fold rewrite is a TPU lane layout computing the
        same function."""
        lg = logging.getLogger("base")
        for key in ("eval_tp", "eval_pp", "eval_spatial"):
            if self.opt.get(key):
                raise NotImplementedError(_PARALLEL.format(key))
        if self.opt.get("dist_eval") and self.eval_devices() > 1:
            raise NotImplementedError(_PARALLEL.format("dist_eval over several devices"))
        fold = int((self.opt.get("network_G") or {}).get("fold") or 1)
        if fold > 1:
            lg.info("network_G.fold=%d: the port runs the unfolded forward (the same function); "
                    "eval_spatial_fold does not apply", fold)
        se = bool(self.opt.get("self_ensemble"))
        if se:
            lg.info("self_ensemble: x8 dihedral eval forward (two batched calls: 4 flips + "
                    "4 transposed), CEM-projected mean")
        return make_eval_forward(self.g_module, self.cem, self_ensemble=se)

    def eval_devices(self) -> int:
        """Devices a ``dist_eval`` run would use: the CUDA devices (capped by
        ``gpu_ids``) when the model is on CUDA, else 1."""
        if self.device.type != "cuda":
            return 1
        n = torch.cuda.device_count()
        ids = self.opt.get("gpu_ids")
        return min(n, len(ids)) if ids else n

    def load_network(self, path: str) -> None:
        """Load a torch ``.pth`` state dict with the reference ESRGAN keys
        into the generator, strictly: the file
        ``esr_tpu/scripts/export_torch_weights.py`` writes from a JAX
        checkpoint. The kernels' weight layouts built from the old weights
        are dropped, and an eval forward is rebuilt on the new ones."""
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory (an orbax checkpoint of the JAX package?); the port loads a "
                "torch .pth state dict — convert it with `python -m esr_tpu.scripts.export_torch_weights "
                f"--kind rrdb --ckpt {path} --out G.pth`")
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.g_module.load_state_dict(state, strict=True)
        self.g_module.release_kernels()
        if getattr(self, "_forward", None) is not None:
            self._forward = self._make_forward()

    def feed_data(self, data: dict) -> None:
        self._data = data

    def get_current_visuals(self) -> dict:
        """Visuals as host numpy float arrays (fetched once, on demand)."""
        self._visuals = {
            k: v.float().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in self._visuals.items()
        }
        return self._visuals

    def get_visuals_device(self) -> dict:
        """The stored visuals: tensors on the device where ``test()`` left
        them, host numpy for loader entries such as HR."""
        return self._visuals

    def get_visuals_uint8(self) -> dict:
        """Visuals as uint8 HWC images, converted on the device before the
        fetch (:func:`esr_tpu_torch.ops.color.to_uint8`)."""
        out = {}
        for k, v in self._visuals.items():
            if isinstance(v, np.ndarray):
                out[k] = tensor2img(v)
            else:
                a = to_uint8(v).cpu().numpy()
                out[k] = a[..., 0] if a.ndim == 3 and a.shape[-1] == 1 else a
        return out

    # -- training surface ----------------------------------------------------

    def _prep_batch(self, data: dict):
        """The loader batch as the train step takes it, on the device: the HR
        crops, or ``{'HR', 'LR'}`` when ``dataroot_LR`` is configured (paired
        LR, never synthesised)."""
        hr = torch.as_tensor(np.asarray(data["HR"])).to(self.device, non_blocking=True)
        if not getattr(self, "_paired_lr", False):
            return hr
        if data.get("LR") is None:
            raise ValueError("dataroot_LR is configured (paired-LR training) but the batch carries "
                             "no LR array — check the dataset/loader")
        return {"HR": hr, "LR": torch.as_tensor(np.asarray(data["LR"])).to(self.device)}

    def get_current_losses(self) -> dict:
        """The last step's metrics as host floats, fetched in one copy."""
        items = list(self._losses.items())
        if not items:
            return {}
        packed = torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(-1)[-1].to(self.device)
                              for _, v in items]).cpu().tolist()
        return {k: float(v) for (k, _), v in zip(items, packed)}

    def get_current_learning_rate(self) -> float:
        sched = next(iter(self.schedulers.values()), None)
        return float(sched(self.step)) if sched is not None else 0.0

    def save_network(self, net: nn.Module, network_label: str, iter_label) -> str:
        path = os.path.join(self.opt["path"]["models"], f"{iter_label}_{network_label}.pth")
        torch.save(net.state_dict(), path)
        return path

    def _load_module(self, net: nn.Module, path: str) -> None:
        if os.path.isdir(path):
            raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX package?); the port "
                             "loads torch .pth state dicts")
        net.load_state_dict(torch.load(path, map_location=self.device, weights_only=True), strict=True)

    def save_training_state(self, epoch: int, iter_step: int, states: dict) -> str:
        """``<training_state>/<iter>.state``: epoch, iter and, per network, its
        state_dict and its optimiser's state."""
        path = os.path.join(self.opt["path"]["training_state"], f"{iter_step}.state")
        tmp = path + ".tmp"
        torch.save({"epoch": int(epoch), "iter": int(iter_step), **states}, tmp)
        os.replace(tmp, path)
        return path

    def restore_training_state(self, path: str) -> dict:
        return torch.load(path, map_location=self.device, weights_only=True)

    @staticmethod
    def latest_state_path(state_dir: str) -> str | None:
        """The newest ``<iter>.state`` in ``state_dir`` (auto-resume)."""
        if not os.path.isdir(state_dir):
            return None
        states = [f for f in os.listdir(state_dir) if f.endswith(".state")]
        if not states:
            return None
        states.sort(key=lambda f: int(f.split(".")[0]))
        return os.path.join(state_dir, states[-1])
