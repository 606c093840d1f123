"""Eval datasets (port of the test phase of esr_tpu/data/lrhr_dataset.py).

``LRHRDataset``: paired LR/HR images from folders; HR is cropped to a
multiple of scale and, without an LR folder, LR is synthesised with
MATLAB-bicubic ``imresize_np``. ``LRDataset``: LR only (no ground truth).
``SyntheticDataset``: the JAX package's seeded procedural images, so eval
runs without a dataset on disk. Samples are dicts of HWC float32 arrays and
paths. The training phase (random crops, augmentation) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from esr_tpu_torch.data import util as data_util
from esr_tpu_torch.ops.resize import imresize_np

__all__ = ["LRHRDataset", "LRDataset", "SyntheticDataset"]


def _eval_only(opt: dict, what: str) -> None:
    if (opt.get("phase") or "train") == "train":
        raise NotImplementedError(
            f"{what}: the training phase is not ported yet (ROADMAP.md Queue 1 item 6, "
            "the GAN training slice); the port's datasets serve eval (phase 'test'/'val')")


class LRHRDataset:
    """Paired LR/HR dataset over image folders (eval phase)."""

    def __init__(self, opt: dict):
        _eval_only(opt, "LRHRDataset")
        self.opt = opt
        self.scale = int(opt.get("scale") or 4)
        self.paths_hr = data_util.get_image_paths(opt.get("dataroot_HR"))
        self.paths_lr = (
            data_util.get_image_paths(opt.get("dataroot_LR")) if opt.get("dataroot_LR") else None
        )
        if self.paths_lr and len(self.paths_lr) != len(self.paths_hr):
            raise ValueError("LR and HR datasets have different sizes")

    def __len__(self) -> int:
        return len(self.paths_hr)

    def __getitem__(self, index: int) -> dict:
        hr_path = self.paths_hr[index]
        lr_path = self.paths_lr[index] if self.paths_lr else hr_path
        hr = data_util.modcrop(data_util.read_img(hr_path), self.scale)
        lr = data_util.read_img(lr_path) if self.paths_lr else imresize_np(hr, scale=1.0 / self.scale)
        return {"HR": hr, "LR": lr, "HR_path": hr_path, "LR_path": lr_path}


class LRDataset:
    """LR-only dataset (blind test: no ground truth)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.paths_lr = data_util.get_image_paths(opt.get("dataroot_LR"))

    def __len__(self) -> int:
        return len(self.paths_lr)

    def __getitem__(self, index: int) -> dict:
        lr_path = self.paths_lr[index]
        return {"LR": data_util.read_img(lr_path), "LR_path": lr_path}


class SyntheticDataset:
    """Seeded procedural HR images (gradients + gaussian blobs + texture),
    the same images as the JAX package's for the same ``n_images`` and
    ``image_size`` (eval phase: modcrop + bicubic LR)."""

    def __init__(self, opt: dict):
        _eval_only(opt, "SyntheticDataset")
        self.opt = opt
        self.scale = int(opt.get("scale") or 4)
        hr_size = data_util.parse_size(opt.get("HR_size"))
        self.n = int(opt.get("n_images") or 16)
        self.image_size = int(opt.get("image_size") or max(*hr_size, 192))

    def __len__(self) -> int:
        return self.n

    def _make_image(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(1000 + index)
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = np.stack(
            [
                0.5 + 0.5 * np.sin(2 * np.pi * (ax * xx + ay * yy + ph))
                for ax, ay, ph in rng.uniform(0, 3, size=(3, 3))
            ],
            axis=-1,
        )
        for _ in range(6):
            cy, cx = rng.uniform(0.1, 0.9, 2)
            sig = rng.uniform(0.02, 0.15)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
            img += blob[..., None] * rng.uniform(-0.5, 0.5, 3)
        img += rng.normal(0, 0.02, img.shape)
        return np.clip(img, 0, 1).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        hr = data_util.modcrop(self._make_image(index), self.scale)
        path = f"synthetic://{index}"
        return {"HR": hr, "LR": imresize_np(hr, scale=1.0 / self.scale), "HR_path": path, "LR_path": path}
