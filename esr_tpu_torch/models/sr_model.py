"""SRModel, eval side (port of esr_tpu/models/sr_model.py: ``__init__``
with ``is_train`` false, ``feed_data``, ``test``).

The generator comes from ``define_G`` on ``device``; its weights from
``path.pretrain_model_G`` (a torch ``.pth``, see ``BaseModel.load_network``)
when set, else ``define_G``'s seeded ones (seed ``train.manual_seed``, 0 by
default). ``use_cem`` wraps the forward in the CEM projection under the
optional top-level ``kernel`` (separable kernels only: the port's CEM has
the matmul mode).
"""

from __future__ import annotations

import numpy as np
import torch

from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.cem.kernels import resolve_kernel
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.models.base_model import BaseModel
from esr_tpu_torch.models.networks import define_G

__all__ = ["SRModel"]


class SRModel(BaseModel):
    def __init__(self, opt: dict, device: str | torch.device = "cuda"):
        super().__init__(opt)
        if self.is_train:
            raise NotImplementedError(
                f"{type(self).__name__}: training is not ported yet (ROADMAP.md Queue 1 item 6, the "
                "GAN training slice); parse the options with is_train=False for eval")
        self.device = resolve_device(device)
        self.scale = int(opt.get("scale") or 4)
        seed = int((opt.get("train") or {}).get("manual_seed") or 0)
        self.g_module = define_G(opt, device=self.device, seed=seed)
        self.nz = self.g_module.num_latent_channels
        kernel = resolve_kernel(opt.get("kernel"))
        self.cem = (
            make_cem(CEMConf(scale=self.scale, kernel=kernel), device=self.device)
            if opt.get("use_cem") else None
        )
        pretrained = (opt.get("path") or {}).get("pretrain_model_G")
        if pretrained:
            self.load_network(pretrained)
        self._forward = self._make_forward()
        self._data: dict = {}

    def test(self, z: np.ndarray | torch.Tensor | None = None) -> None:
        """Forward the fed LR (HWC or NHWC) with Z (zeros when None); SR and
        LR stay on the device until a visuals getter fetches them."""
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
        sr = self._forward(lr, zz)
        self._visuals = {"SR": sr[0], "LR": lr[0]}
        if self._data.get("HR") is not None:
            hr = np.asarray(self._data["HR"])
            self._visuals["HR"] = hr[0] if hr.ndim == 4 else hr
