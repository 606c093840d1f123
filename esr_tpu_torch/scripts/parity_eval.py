"""Reference-parity evaluation of a released generator checkpoint (port of
esr_tpu/scripts/parity_eval.py)::

    python -m esr_tpu_torch.scripts.parity_eval --pth RRDB_PSNR_x4.pth --images Set5/HR \\
        [--lr_images DIR] [--out parity_set5_torch.json] [--device cuda|cpu]

The reference protocol: LR made by MATLAB-faithful bicubic (modcrop,
``imresize``) unless paired ``--lr_images`` are given; the generator in
f32 with TF32 off (cuDNN and matmuls; on the card the f32 convs run on the
f32 kernels, full f32); PSNR / SSIM in the uint8 domain on the Y channel
after a border crop of ``scale`` pixels; the delta against the ESRGAN
paper's Set5 anchor (32.70 dB, the PSNR-oriented RRDB) unless ``--anchor``
says otherwise. The checkpoint may be in either reference key layout (or
wrapped in ``{"state_dict": ...}``), loaded strictly by
``BaseModel.load_network``; an explorable checkpoint's Z channels are read
from ``conv_first``'s input width (3 + Z), and it is scored at Z = 0 plus
``--num_random_z`` uniform draws. The report is the JAX script's; its
default path is its own (``parity_set5_torch.json`` at the repository
root), not the JAX report's, which ``bench.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from esr_tpu_torch.device import full_f32

__all__ = ["run_parity_eval", "main"]

# the ESRGAN paper's (arXiv:1809.00219) Set5 PSNR of the PSNR-oriented RRDB
ESRGAN_SET5_PSNR_ANCHOR = 32.70

DEFAULT_REPORT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                              "parity_set5_torch.json")


def run_parity_eval(
    pth: str,
    images: str,
    lr_images: str | None = None,
    scale: int = 4,
    nb: int = 23,
    nf: int = 64,
    gc: int = 32,
    use_cem: bool = False,
    num_random_z: int = 0,
    anchor: float = ESRGAN_SET5_PSNR_ANCHOR,
    dataset_name: str = "Set5",
    out: str = DEFAULT_REPORT,
    save_images: str | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Load the generator checkpoint ``pth``, evaluate it on ``images`` under
    the reference protocol, and write (to ``out``, unless it is empty) and
    return the parity report."""
    from esr_tpu_torch.data import create_dataloader, create_dataset
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.models.networks import normalize_rrdb_keys
    from esr_tpu_torch.options import parse
    from esr_tpu_torch.test import evaluate_dataset

    state = normalize_rrdb_keys(torch.load(pth, map_location="cpu", weights_only=True))
    nz = max(0, int(state["conv_first.weight"].shape[1]) - 3)  # explorable: Z channels in conv_first
    opt = parse({
        "model": "sr", "scale": scale, "use_cem": use_cem, "bf16": False, "psnr_on_y": True,
        "num_random_Z": num_random_z if nz else 0,
        "network_G": {"which_model_G": "RRDB_net", "in_nc": 3, "out_nc": 3, "nf": nf, "nb": nb, "gc": gc,
                      "num_latent_channels": nz},
        "path": {"pretrain_model_G": pth},
    }, is_train=False)
    ds_opt = {"name": dataset_name, "phase": "test", "mode": "LRHR", "dataroot_HR": images,
              "dataroot_LR": lr_images, "scale": scale}
    with full_f32():
        model = create_model(opt, device=device)  # a wrong --nb / --nf raises in the strict load
        test_set = create_dataset(ds_opt)
        results = evaluate_dataset(model, create_dataloader(test_set, ds_opt), opt, save_dir=save_images)

    psnr = results["psnr"]
    report = {
        "metric": "set5_psnr_delta",
        "dataset": dataset_name,
        "n_images": len(test_set),
        "psnr": round(psnr, 4),
        "ssim": round(results["ssim"], 4),
        "anchor_psnr": anchor,
        "set5_psnr_delta": round(psnr - anchor, 4),
        "checkpoint": os.path.abspath(pth),
        "num_latent_channels": nz,
        "protocol": {"domain": "uint8", "y_channel": True, "border_crop": scale,
                     "lr_source": "paired" if lr_images else "matlab_bicubic_onfly", "precision": "f32",
                     "cem": use_cem},
    }
    for k in ("cem_residual", "z_psnr_mean", "z_psnr_spread", "z_diversity"):
        if k in results:
            report[k] = round(float(results[k]), 6)
    if out:
        with open(out, "w") as fh:
            json.dump(report, fh, indent=1)
            fh.write("\n")
        report["report_path"] = os.path.abspath(out)
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--pth", required=True, help="reference *_G.pth checkpoint")
    parser.add_argument("--images", required=True, help="HR image dir (e.g. Set5/HR)")
    parser.add_argument("--lr_images", default=None, help="paired LR dir (else on-the-fly bicubic)")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--nb", type=int, default=23)
    parser.add_argument("--nf", type=int, default=64)
    parser.add_argument("--gc", type=int, default=32)
    parser.add_argument("--use_cem", action="store_true")
    parser.add_argument("--num_random_z", type=int, default=0)
    parser.add_argument("--anchor", type=float, default=ESRGAN_SET5_PSNR_ANCHOR)
    parser.add_argument("--dataset_name", default="Set5")
    parser.add_argument("--out", default=DEFAULT_REPORT)
    parser.add_argument("--save_images", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    report = run_parity_eval(**vars(parser.parse_args(argv)))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
