"""Datasets (port of esr_tpu/data/lrhr_dataset.py).

``LRHRDataset``: paired LR/HR images from folders. ``LRDataset``: LR only
(no ground truth). ``SyntheticDataset``: the JAX package's seeded procedural
images, so training and eval run without a dataset on disk. Samples are dicts
of HWC arrays and paths.

Eval phase (``test``/``val``): HR cropped to a multiple of scale and, without
an LR folder, LR synthesised with MATLAB-bicubic ``imresize_np``.

Train phase: a random aligned crop of ``HR_size`` (and of the LR folder's
image at HR_size / scale). The crop is a pure function of (seed, epoch,
index) (``set_epoch``), so a resumed run replays the crops of the original.
With ``on_device_processing`` (the default) the sample is the uint8 crop and
LR synthesis, augmentation and normalisation run on the device in the train
step (``data/pipeline.py``); without it the host does all of them.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import numpy as np

from esr_tpu_torch.data import util as data_util
from esr_tpu_torch.ops.resize import imresize_np

__all__ = ["LRHRDataset", "LRDataset", "SyntheticDataset"]


class _EpochDraws:
    """Crop draws that are a pure function of (seed, epoch, index)."""

    def __init__(self, opt: dict):
        self.seed = int(opt.get("seed") or 0)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The loader calls this each epoch: resuming at epoch E replays the
        crops the original run drew there."""
        self._epoch = int(epoch)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self._epoch, index))


class LRHRDataset(_EpochDraws):
    """Paired LR/HR dataset over image folders."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = int(opt.get("scale") or 4)
        self.hr_size = data_util.parse_size(opt.get("HR_size"))
        self.paths_hr = data_util.get_image_paths(opt.get("dataroot_HR"))
        self.paths_lr = (
            data_util.get_image_paths(opt.get("dataroot_LR")) if opt.get("dataroot_LR") else None
        )
        if self.paths_lr and len(self.paths_lr) != len(self.paths_hr):
            raise ValueError("LR and HR datasets have different sizes")
        self.on_device_processing = bool(opt.get("on_device_processing", True))
        # rot90 on a rectangular crop transposes per sample, so a batch
        # augmented on the host would mix (H, W) and (W, H) shapes
        if (self.phase == "train" and not self.on_device_processing and bool(opt.get("use_rot", True))
                and self.hr_size[0] != self.hr_size[1]):
            raise ValueError(f"use_rot requires square train crops, got HR_size {self.hr_size[0]}x"
                             f"{self.hr_size[1]} — set use_rot: false for non-square crops")

    def __len__(self) -> int:
        return len(self.paths_hr)

    def __getitem__(self, index: int) -> dict:
        hr_path = self.paths_hr[index]
        lr_path = self.paths_lr[index] if self.paths_lr else hr_path
        paths = {"HR_path": hr_path, "LR_path": lr_path}
        if self.phase == "train":
            rng = self._rng(index)
            if self.on_device_processing:
                hr = data_util.read_img_uint8(hr_path)
                lr = data_util.read_img_uint8(lr_path) if self.paths_lr else None
                hr, lr = data_util.random_crop_pair(hr, lr, self.hr_size, self.scale, rng)
                return {"HR": hr, "LR": lr, **paths}
            hr = data_util.read_img(hr_path)
            lr = data_util.read_img(lr_path) if self.paths_lr else None
            hr, lr = data_util.random_crop_pair(hr, lr, self.hr_size, self.scale, rng)
            if lr is None:
                lr = imresize_np(hr, scale=1.0 / self.scale)
            hr, lr = data_util.augment([hr, lr], self.opt.get("use_flip", True), self.opt.get("use_rot", True), rng)
            return {"HR": hr, "LR": lr, **paths}
        hr = data_util.modcrop(data_util.read_img(hr_path), self.scale)
        lr = data_util.read_img(lr_path) if self.paths_lr else imresize_np(hr, scale=1.0 / self.scale)
        return {"HR": hr, "LR": lr, **paths}


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


class SyntheticDataset(_EpochDraws):
    """Seeded procedural HR images (gradients + gaussian blobs + texture),
    the same images as the JAX package's for the same ``n_images`` and
    ``image_size``. Train phase: a uint8 crop (the same 8-bit grid a PNG
    training set has); eval phase: modcrop + bicubic LR.

    Made images are kept in an LRU cache of at most ``CACHE_IMAGES``
    (a deliberate divergence: the JAX package keeps every image it made, so
    a large ``n_images`` grows without bound); an evicted image is made again
    from its seed, bit for bit."""

    CACHE_IMAGES = 32

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = int(opt.get("scale") or 4)
        self.hr_size = data_util.parse_size(opt.get("HR_size"))
        self.n = int(opt.get("n_images") or 16)
        self.image_size = int(opt.get("image_size") or max(*self.hr_size, 192))
        self._img_cache: OrderedDict[int, np.ndarray] = OrderedDict()

    def __len__(self) -> int:
        return self.n

    def _make_image(self, index: int) -> np.ndarray:
        # a pure function of the index (the epoch varies only the crop), so
        # the most recently used ones are kept
        # each cache operation is one call (loader threads may share the dataset): a
        # concurrent eviction costs a remake, never an error
        img = self._img_cache.get(index)
        if img is not None:
            with contextlib.suppress(KeyError):
                self._img_cache.move_to_end(index)
            return img
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
        img = np.clip(img, 0, 1).astype(np.float32)
        self._img_cache[index] = img
        if len(self._img_cache) > self.CACHE_IMAGES:
            with contextlib.suppress(KeyError):
                self._img_cache.popitem(last=False)
        return img

    def __getitem__(self, index: int) -> dict:
        hr = self._make_image(index)
        path = f"synthetic://{index}"
        if self.phase == "train":
            hr, _ = data_util.random_crop_pair(hr, None, self.hr_size, self.scale, self._rng(index))
            hr = (hr * 255.0).round().astype(np.uint8)
            return {"HR": hr, "LR": None, "HR_path": path, "LR_path": path}
        hr = data_util.modcrop(hr, self.scale)
        return {"HR": hr, "LR": imresize_np(hr, scale=1.0 / self.scale), "HR_path": path, "LR_path": path}
