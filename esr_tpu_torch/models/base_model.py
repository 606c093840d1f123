"""The eval forward and the models' eval surface (port of the single-device
eval parts of esr_tpu/models/base_model.py).

``make_eval_forward``: the generator, then the exact CEM projection.
``BaseModel``: what the eval CLI and the export path call on a model —
``_make_forward`` (the options' wrappers around ``make_eval_forward``),
``load_network`` and the visuals getters.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from esr_tpu_torch.models.architecture import RRDBNet
from esr_tpu_torch.ops.color import tensor2img, to_uint8
from esr_tpu_torch.ops.ensemble import make_self_ensemble

__all__ = ["BaseModel", "make_eval_forward"]

_PARALLEL = ("multi-device eval ({}) is not ported yet (ROADMAP.md Queue 1 item 10, the parallel "
             "axes); the port evaluates on one device")


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
        checkpoint."""
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory (an orbax checkpoint of the JAX package?); the port loads a "
                "torch .pth state dict — convert it with `python -m esr_tpu.scripts.export_torch_weights "
                f"--kind rrdb --ckpt {path} --out G.pth`")
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.g_module.load_state_dict(state, strict=True)

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
