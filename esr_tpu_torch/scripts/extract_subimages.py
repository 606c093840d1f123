"""Offline sub-image extraction (port of esr_tpu/scripts/extract_subimages.py)::

    python -m esr_tpu_torch.scripts.extract_subimages --input HR_DIR --output OUT_DIR \\
        --crop_size 480 --step 240 --threshold 48

Cuts every image into ``crop_size`` squares every ``step`` pixels (the
reference's DIV2K 480 x 480 sub-images for fast loading), plus one flush
with the bottom / right edge when the margin left is above ``threshold``;
images smaller than a crop are skipped. Writes ``<name>_s{idx:03d}.png``.
"""

from __future__ import annotations

import argparse
import os

from esr_tpu_torch.data.util import get_image_paths, read_img, save_img
from esr_tpu_torch.ops.color import tensor2img

__all__ = ["main"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--crop_size", type=int, default=480)
    parser.add_argument("--step", type=int, default=240)
    parser.add_argument("--threshold", type=int, default=48, help="discard leftover margins smaller than this")
    args = parser.parse_args(argv)
    size = args.crop_size
    os.makedirs(args.output, exist_ok=True)
    n_out = n_skipped = 0
    for p in get_image_paths(args.input):
        img = read_img(p)
        h, w = img.shape[:2]
        if h < size or w < size:
            print(f"skip {p}: {h}x{w} smaller than crop_size {size}")
            n_skipped += 1
            continue
        base = os.path.splitext(os.path.basename(p))[0]
        ys = list(range(0, h - size + 1, args.step))
        xs = list(range(0, w - size + 1, args.step))
        if h - (ys[-1] + size) > args.threshold:
            ys.append(h - size)
        if w - (xs[-1] + size) > args.threshold:
            xs.append(w - size)
        for idx, (y, x) in enumerate(((y, x) for y in ys for x in xs), start=1):
            save_img(tensor2img(img[y : y + size, x : x + size]), os.path.join(args.output, f"{base}_s{idx:03d}.png"))
            n_out += 1
    skipped = f" ({n_skipped} undersized inputs skipped)" if n_skipped else ""
    print(f"wrote {n_out} sub-images to {args.output}{skipped}")


if __name__ == "__main__":
    main()
