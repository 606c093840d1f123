"""Check a torch weight file and write it as this port's strict loaders take
it (port of esr_tpu/scripts/convert_torch_weights.py, which writes orbax
trees; the port keeps torch files)::

    python -m esr_tpu_torch.scripts.convert_torch_weights --kind rrdb --pth RRDB_ESRGAN_x4.pth --out G.pth
    python -m esr_tpu_torch.scripts.convert_torch_weights --kind vgg19 --pth vgg19.pth --out vgg19.pth

``rrdb``: a released reference generator (new or old key layout, a
``{"state_dict": ...}`` wrapper unwrapped) with its keys normalized
(``models.networks.normalize_rrdb_keys``), loaded strictly into an RRDBNet
of the widths it holds before it is written. ``discriminator``: loaded
strictly into a ``DiscriminatorVGG128`` of its width and crop, then written
as it is. ``vgg19``: a torchvision ``vgg19`` state dict, checked for the
``features.{i}`` keys ``VGG19FeatureExtractor.load_torchvision`` needs (to
conv5_4), then written as it is. ``path.pretrain_model_G`` reads either
layout of a generator without this step; the script checks a file once and
leaves one layout on disk. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import math

import torch

from esr_tpu_torch.models.architecture import DiscriminatorVGG128, RRDBNet, VGG19FeatureExtractor
from esr_tpu_torch.models.networks import normalize_rrdb_keys, rrdb_options_from_state

__all__ = ["convert", "main"]


def convert(state: dict, kind: str, scale: int = 4) -> dict:
    """``state`` as the port's strict loader of ``kind`` takes it; raises
    when it does not load."""
    if isinstance(state.get("state_dict"), dict):
        state = state["state_dict"]
    if kind == "rrdb":
        state = normalize_rrdb_keys(state)
        o = rrdb_options_from_state(state)
        RRDBNet(in_nc=o["in_nc"], out_nc=o["out_nc"], nf=o["nf"], nb=o["nb"], gc=o["gc"], scale=scale,
                num_latent_channels=o["num_latent_channels"],
                latent_input=o["latent_input"]).load_state_dict(state, strict=True)
    elif kind == "discriminator":
        nf = int(state["conv0_0.weight"].shape[0])
        side = math.isqrt(int(state["linear1.weight"].shape[1]) // (8 * nf)) * 32  # a square train crop
        d = DiscriminatorVGG128(in_nc=int(state["conv0_0.weight"].shape[1]), nf=nf,
                                norm="batch" if "bn0_1.weight" in state else "none", hr_size=(side, side))
        d.load_state_dict(state, strict=True)
    elif kind == "vgg19":
        VGG19FeatureExtractor(feature_layer=34).load_torchvision(state)
    else:
        raise ValueError(f"kind {kind!r}: rrdb, discriminator or vgg19")
    return state


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--kind", choices=["rrdb", "vgg19", "discriminator"], required=True)
    parser.add_argument("--pth", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--scale", type=int, default=4, help="the generator's scale (rrdb)")
    args = parser.parse_args(argv)
    state = convert(torch.load(args.pth, map_location="cpu", weights_only=True), args.kind, args.scale)
    torch.save(state, args.out)
    print(f"saved {args.kind} state_dict ({len(state)} tensors) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
