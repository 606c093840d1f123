"""Offline LR/HR pair generation (port of esr_tpu/scripts/generate_mod_lr_bic.py)::

    python -m esr_tpu_torch.scripts.generate_mod_lr_bic --input HR_DIR --output OUT_DIR --scales 2 3 4

For each scale: every HR image modcropped to a multiple of the scale
(``HR_x{s}/``), its MATLAB-bicubic LR (``LR_x{s}/``) and, with
``--save_bic_up``, that LR bicubically upscaled back (``Bic_x{s}/``), as
PNGs of the same names. Host numpy only (``ops/resize.imresize_np``).
"""

from __future__ import annotations

import argparse
import os

from esr_tpu_torch.data.util import get_image_paths, modcrop, read_img, save_img
from esr_tpu_torch.ops.color import tensor2img
from esr_tpu_torch.ops.resize import imresize_np

__all__ = ["main"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--scales", nargs="+", type=int, default=[4])
    parser.add_argument("--save_bic_up", action="store_true", help="also save the bicubic re-upscaled LR")
    args = parser.parse_args(argv)
    paths = get_image_paths(args.input)
    for scale in args.scales:
        for p in paths:
            img = modcrop(read_img(p), scale)
            name = os.path.basename(p)
            save_img(tensor2img(img), os.path.join(args.output, f"HR_x{scale}", name))
            lr = imresize_np(img, scale=1.0 / scale)
            save_img(tensor2img(lr), os.path.join(args.output, f"LR_x{scale}", name))
            if args.save_bic_up:
                save_img(tensor2img(imresize_np(lr, scale=scale)), os.path.join(args.output, f"Bic_x{scale}", name))
        print(f"x{scale}: {len(paths)} images -> {args.output}")


if __name__ == "__main__":
    main()
