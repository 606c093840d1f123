"""Export a model as a serving artifact (port of
esr_tpu/scripts/export_model.py)::

    python -m esr_tpu_torch.scripts.export_model \\
        -opt esr_tpu_torch/options/test/test_explorable.json \\
        --shapes 1x128x128,4x128x128,1x256x256 --out /path/artifact_dir [--device cuda|cpu]

The artifact (``manifest.json`` + ``G.pth``, see ``esr_tpu_torch.export``)
needs ``esr_tpu_torch`` to load; ``esr_tpu_torch.scripts.serve`` serves it.
Weights come from the options' ``path.pretrain_model_G`` (a torch ``.pth``),
else the seeded ones of ``define_G``.
"""

from __future__ import annotations

import argparse

from esr_tpu_torch.export import export_servable
from esr_tpu_torch.models import create_model
from esr_tpu_torch.options import parse

__all__ = ["main", "parse_shapes"]


def parse_shapes(text: str) -> list[tuple[int, int, int]]:
    shapes = []
    for part in text.split(","):
        dims = [int(x) for x in part.lower().split("x")]
        if len(dims) != 3 or min(dims) < 1:
            raise ValueError(f"bad bucket '{part}': expected BATCHxHxW, e.g. 1x128x128")
        shapes.append(tuple(dims))
    return shapes


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-opt", required=True, help="test options JSON")
    parser.add_argument("--shapes", default="1x128x128", help="comma-separated LR buckets BATCHxHxW")
    parser.add_argument("--out", required=True, help="artifact output directory")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    model = create_model(parse(args.opt, is_train=False), device=args.device)
    manifest = export_servable(model, parse_shapes(args.shapes), args.out)
    print(f"exported {len(manifest['buckets'])} bucket(s) to {args.out} "
          f"(scale x{manifest['scale']}, nz={manifest['nz']}, format {manifest['format']})")
    return manifest


if __name__ == "__main__":
    main()
