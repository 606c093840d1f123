"""One-command tour on synthetic data, no datasets or weights needed (port
of esr_tpu/scripts/quickstart.py)::

    python -m esr_tpu_torch.scripts.quickstart [--root DIR] [--niter 200] [--flagship] [--device cuda|cpu]

Runs the workflow end to end at toy scale:

1. writes a small folder of synthetic HR PNGs;
2. trains an explorable model (``model: srragan``, CEM, one Z channel)
   through the train CLI (``esr_tpu_torch.train.main``);
3. evaluates it through the test CLI (PSNR / SSIM / CEM residual and two
   random Z draws);
4. makes one exploration edit (variance up on the central region) through
   the editor's session and saves the SR.

The default net (nf 8, nb 1, gc 4, f32) runs in a few minutes on a CPU;
``--flagship`` trains the real RRDBNet (nf 64, nb 23, gc 32, bf16) on the
card. The option files it writes under ``--root`` are ordinary configs.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

__all__ = ["main"]


def _write_images(root: str, n: int = 4, size: int = 96) -> str:
    from esr_tpu_torch.data.lrhr_dataset import SyntheticDataset
    from esr_tpu_torch.data.util import save_img
    from esr_tpu_torch.ops.color import tensor2img

    img_dir = os.path.join(root, "imgs")
    ds = SyntheticDataset({"phase": "val", "n_images": n, "image_size": size})
    for i in range(n):
        save_img(tensor2img(ds[i]["HR"]), os.path.join(img_dir, f"img{i}.png"))
    return img_dir


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "esr_quickstart"))
    p.add_argument("--niter", type=int, default=200)
    p.add_argument("--flagship", action="store_true", help="the full nb 23 / nf 64 model (the default is a toy net)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    dev = ["--device", args.device]

    net_g = ({"which_model_G": "RRDB_net", "nf": 64, "nb": 23, "gc": 32, "num_latent_channels": 1}
             if args.flagship else {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4, "num_latent_channels": 1})
    hr_size = 128 if args.flagship else 32
    # images larger than the crop, so training never sees reflect padding
    img_dir = _write_images(root, size=hr_size + 64)
    print(f"[1/4] synthetic dataset at {img_dir}", flush=True)
    train_opt = {
        "name": "quickstart", "model": "srragan", "scale": 4, "use_cem": True, "bf16": bool(args.flagship),
        "datasets": {
            "train": {"name": "syn", "mode": "LRHR", "dataroot_HR": img_dir, "HR_size": hr_size,
                      "batch_size": 4 if args.flagship else 2, "use_shuffle": True},
            "val": {"name": "syn_val", "mode": "LRHR", "dataroot_HR": img_dir},
        },
        "path": {"root": root},
        "network_G": net_g,
        "network_D": {"which_model_D": "discriminator_vgg_128", "nf": 64 if args.flagship else 8},
        "network_F": {"which_model_F": "vgg19", "feature_layer": 34},
        "train": {"lr_G": 1e-4, "lr_D": 1e-4, "niter": args.niter, "val_freq": max(args.niter // 2, 1),
                  "pixel_weight": 0.01, "feature_weight": 1.0, "gan_weight": 0.005, "range_weight": 1.0,
                  "map_weight": 1.0, "manual_seed": 0},
        "logger": {"print_freq": max(args.niter // 10, 1), "save_checkpoint_freq": args.niter},
    }
    train_path = os.path.join(root, "train_opt.json")
    with open(train_path, "w") as f:
        json.dump(train_opt, f, indent=2)

    from esr_tpu_torch.train import main as train_main

    print(f"[2/4] training {args.niter} explorable GAN steps ({train_path})", flush=True)
    train_main(["-opt", train_path, *dev])
    g_ckpt = os.path.join(root, "experiments", "quickstart", "models", "latest_G.pth")

    test_opt = {
        "name": "quickstart_eval", "model": "srragan", "scale": 4, "use_cem": True, "bf16": bool(args.flagship),
        "is_train": False,
        "datasets": {"test_1": {"name": "syn_val", "mode": "LRHR", "dataroot_HR": img_dir}},
        "path": {"root": root, "pretrain_model_G": g_ckpt},
        "network_G": net_g,
        "num_random_Z": 2,
    }
    test_path = os.path.join(root, "test_opt.json")
    with open(test_path, "w") as f:
        json.dump(test_opt, f, indent=2)

    from esr_tpu_torch.test import main as test_main

    print(f"[3/4] evaluating ({test_path})", flush=True)
    test_main(["-opt", test_path, "--save_images", *dev])

    print("[4/4] exploration: variance+ on a center region", flush=True)
    from esr_tpu_torch.explore.cli import build_session_from_opt

    session = build_session_from_opt(test_path, os.path.join(img_dir, "img0.png"), device=args.device)
    hh, ww = session.hr_shape
    session.select_rect(hh // 4, ww // 4, 3 * hh // 4, 3 * ww // 4)
    session.increase_variance()
    edited = os.path.join(root, "edited_sr.png")
    session.save_sr(edited)
    print(f"done — edited SR written to {edited}; configs under {root}", flush=True)
    return edited


if __name__ == "__main__":
    main()
