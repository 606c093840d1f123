"""Build a packed training dataset (port of
esr_tpu/scripts/create_packed_dataset.py)::

    python -m esr_tpu_torch.scripts.create_packed_dataset --input SUBIMAGES_DIR \\
        --output datasets/div2k_pack --size 480

Every image as uint8, reflect-padded up to ``size`` where it is smaller and
cropped to ``size`` x ``size``, stacked into one ``<output>.npy`` with its
``<output>.json`` (``data/packed.write_packed``): the file a ``PACKED``
train dataset maps.
"""

from __future__ import annotations

import argparse

import numpy as np

from esr_tpu_torch.data.packed import write_packed
from esr_tpu_torch.data.util import get_image_paths, read_img

__all__ = ["main"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--size", type=int, default=480, help="crop/pad every image to size x size")
    args = parser.parse_args(argv)
    s = args.size
    imgs = []
    for p in get_image_paths(args.input):
        img = (read_img(p) * 255).round().astype(np.uint8)
        h, w = img.shape[:2]
        if h < s or w < s:
            img = np.pad(img, ((0, max(0, s - h)), (0, max(0, s - w)), (0, 0)), mode="reflect")
        imgs.append(img[:s, :s])
    write_packed(imgs, args.output, meta={"source": args.input})
    print(f"packed {len(imgs)} images ({s}px) -> {args.output}.npy")


if __name__ == "__main__":
    main()
