"""Packed-array dataset (port of esr_tpu/data/packed.py).

Equal-size uint8 HR images packed into one memory-mapped ``.npy`` (with a
``.json`` beside it), so a training read is one mmap slice: no decode.
Sample contract as ``LRHRDataset``'s train phase: ``{'HR': uint8 crop,
'LR': None}``; LR synthesis and augmentation run on the device.
"""

from __future__ import annotations

import json
import os

import numpy as np

from esr_tpu_torch.data.lrhr_dataset import _EpochDraws
from esr_tpu_torch.data.util import parse_size

__all__ = ["PackedDataset", "write_packed"]


def write_packed(images, out_path: str, meta: dict | None = None) -> None:
    """Pack equal-shaped HWC uint8 images into ``<out>.npy`` + ``<out>.json``."""
    arr = np.stack([np.asarray(im, dtype=np.uint8) for im in images])
    np.save(out_path + ".npy", arr)
    with open(out_path + ".json", "w") as f:
        json.dump({"n": int(arr.shape[0]), "shape": list(arr.shape[1:]), **(meta or {})}, f)


class PackedDataset(_EpochDraws):
    """Random-access crops from a packed .npy (mode 'PACKED'); the crop is a
    pure function of (seed, epoch, index)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.opt = opt
        path = opt.get("dataroot_HR")
        if path.endswith(".npy"):
            path = path[:-4]
        if not os.path.exists(path + ".npy"):
            raise FileNotFoundError(f"packed dataset not found: {path}.npy")
        self.data = np.load(path + ".npy", mmap_mode="r")
        self.hr_size = parse_size(opt.get("HR_size"))
        self.phase = opt.get("phase", "train")

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def __getitem__(self, index: int) -> dict:
        img = self.data[index]
        h, w = img.shape[:2]
        sh, sw = self.hr_size
        if self.phase == "train" and (h != sh or w != sw):
            if h < sh or w < sw:
                # reflect-pad the short dims, as random_crop_pair does
                img = np.pad(img, ((0, max(0, sh - h)), (0, max(0, sw - w)), (0, 0)), mode="reflect")
                h, w = img.shape[:2]
            rng = self._rng(index)
            y = int(rng.integers(0, h - sh + 1))
            x = int(rng.integers(0, w - sw + 1))
            img = img[y : y + sh, x : x + sw]
        path = f"packed://{index}"
        return {"HR": np.asarray(img), "LR": None, "HR_path": path, "LR_path": path}
