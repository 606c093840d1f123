"""The x8 self-ensemble's quality gain and its cost (port of
esr_tpu/scripts/ensemble_bench.py)::

    python -m esr_tpu_torch.scripts.ensemble_bench [--opt O.json] [--ckpt G.pth] \\
        [--n 4] [--size 96] [--dataroot DIR] [--iters 6] [--time_lr 64] [--device cuda|cpu]

Quality: PSNR / SSIM with and without ``self_ensemble`` through the eval
loop (``esr_tpu_torch.test.evaluate_dataset``: CEM projection, uint8
metrics, the same Z draws), on a folder (``--dataroot``) or a SYNTHETIC set
of ``--n`` images of ``--size`` px. The claim is relative: ensemble minus
plain on one checkpoint. Cost: the two forwards at B1 x LR ``--time_lr``,
HR megapixels per second and their ratio (CUDA events on the card, the host
clock on the CPU).

The model is the options file's (``--opt``; its generator from ``--ckpt``,
a G ``.pth`` in either reference layout) or, without one, the flagship
(RRDBNet nf 64, nb 23, gc 32, x4, one Z channel, bf16, CEM) on seeded
weights or ``--ckpt``. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

__all__ = ["main"]

FLAGSHIP = {"name": "ensemble_bench", "model": "sr", "scale": 4, "use_cem": True, "bf16": True,
            "network_G": {"which_model_G": "RRDB_net", "nf": 64, "nb": 23, "gc": 32, "num_latent_channels": 1}}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--opt", default=None, help="eval options JSON (default: the flagship)")
    parser.add_argument("--ckpt", default=None, help="generator .pth (default: seeded weights)")
    parser.add_argument("--n", type=int, default=4, help="eval images")
    parser.add_argument("--size", type=int, default=96, help="synthetic HR px")
    parser.add_argument("--dataroot", default=None, help="eval image dir (else synthetic)")
    parser.add_argument("--iters", type=int, default=6, help="timing iterations")
    parser.add_argument("--time_lr", type=int, default=64, help="LR px for the cost timing")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from esr_tpu_torch.data import create_dataloader, create_dataset
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse
    from esr_tpu_torch.test import evaluate_dataset
    from esr_tpu_torch.utils.profiler import StepTimer

    if args.opt:
        with open(args.opt) as fh:
            base = json.load(fh)
    else:
        base = copy.deepcopy(FLAGSHIP)
    base.update(model="sr", is_train=False)
    path = base.setdefault("path", {})
    if args.ckpt:
        path["pretrain_model_G"] = args.ckpt
    path.pop("pretrain_model_D", None)
    path.pop("resume_state", None)
    if args.dataroot:
        ds = {"name": "eval", "mode": "LRHR", "dataroot_HR": args.dataroot}
    else:
        ds = {"name": "synth_eval", "mode": "SYNTHETIC", "phase": "val", "n_images": args.n, "image_size": args.size}
    base["datasets"] = {"test_1": ds}
    opt = parse(base, is_train=False)
    model = create_model(opt, device=args.device)
    dev = model.device

    results, timing = {}, {}
    s = args.time_lr
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.random((1, s, s, 3), dtype=np.float32)).to(dev)
    z = torch.zeros((1, s, s, model.nz), device=dev) if model.nz else None
    for label, ens in (("plain", False), ("ensemble", True)):
        model.opt["self_ensemble"] = ens
        model._forward = model._make_forward()  # same weights; the forward with or without x8
        d = opt["datasets"]["test_1"]
        t0 = time.perf_counter()
        res = evaluate_dataset(model, create_dataloader(create_dataset(d), d), opt)
        results[label] = {"psnr": res["psnr"], "ssim": res["ssim"], "cem_residual": res.get("cem_residual"),
                          "eval_wall_s": time.perf_counter() - t0}
        print(f"[{label}] {results[label]}", flush=True)
        timer = StepTimer(warmup=1, device=dev)  # the warmup: the layouts and the cuDNN plans
        for _ in range(args.iters + 1):
            with timer.step():
                model._forward(lr, z)
        ms = 1e3 * timer.mean
        timing[label] = {"ms": ms, "mp_per_s": (s * model.scale) ** 2 / 1e6 / (ms / 1e3)}

    line = {
        "metric": "self_ensemble_ledger",
        "ckpt": args.ckpt,
        "psnr_delta_db": results["ensemble"]["psnr"] - results["plain"]["psnr"],
        "ssim_delta": results["ensemble"]["ssim"] - results["plain"]["ssim"],
        "cost_factor": timing["ensemble"]["ms"] / timing["plain"]["ms"],
        "plain": {**results["plain"], **timing["plain"]},
        "ensemble": {**results["ensemble"], **timing["ensemble"]},
        "time_lr_px": s,
        "platform": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
