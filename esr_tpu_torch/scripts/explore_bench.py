"""The exploration editor's latency per tool click (port of
esr_tpu/scripts/explore_bench.py)::

    python -m esr_tpu_torch.scripts.explore_bench [--lr_size 64] [--regions 10 24 64] \\
        [--n_steps 64] [--iters 4] [--ckpt G.pth | --opt O.json] [--device cuda|cpu]

What a user of the editor waits for, on an ``ExplorationSession`` over a
seeded LR image:

- ``first_s``: the first click (variance up) on a region of a new size;
- ``click_s``: the median repeat click there (one Z search of ``n_steps``
  Adam steps, the SR fetched), and ``steps_per_s`` = n_steps / click_s;
- ``render_s``: the whole-image SR re-render and its fetch (the preview);
- ``adaptive_imprint``: an adaptive imprint (rounds escalating on
  plateaus), first and repeat, and its rounds;
- ``alternatives``: with ``--alternatives K``, K diverse candidates.

The generator is the flagship (RRDBNet nf 64, ``--nb`` blocks, gc 32, x4,
one Z channel, bf16, CEM matmul) on seeded weights, or loaded from
``--ckpt`` (a G ``.pth`` of those widths, either reference layout), or the
model of an eval options file (``--opt``, with ``--ckpt`` as its
``pretrain_model_G``). Times are host-clock seconds (every click ends in a
fetch of Z or the SR). Prints one JSON line; ``platform`` is the device's
name.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

__all__ = ["main"]


def _session(args):
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.explore.session import ExplorationSession
    from esr_tpu_torch.models import create_model, define_G
    from esr_tpu_torch.models.networks import normalize_rrdb_keys
    from esr_tpu_torch.options import parse

    lr_img = np.random.default_rng(0).random((args.lr_size, args.lr_size, 3)).astype(np.float32)
    if args.opt:
        with open(args.opt) as fh:
            base = json.load(fh)
        base.update(model="sr", is_train=False)
        path = base.setdefault("path", {})
        if args.ckpt:
            path["pretrain_model_G"] = args.ckpt
        path.pop("pretrain_model_D", None)
        path.pop("resume_state", None)
        opt = parse(base, is_train=False)
        model = create_model(opt, device=args.device)
        g, cem, nz, scale = model.g_module, model.cem, model.nz or 1, int(opt.get("scale") or 4)
    else:
        opt = {"network_G": {"nf": 64, "nb": args.nb, "gc": 32, "num_latent_channels": 1}, "scale": 4, "bf16": True}
        g = define_G(opt, device=args.device, seed=0)
        if args.ckpt:
            g.load_state_dict(normalize_rrdb_keys(torch.load(args.ckpt, map_location="cpu", weights_only=True)),
                              strict=True)
        cem, nz, scale = make_cem(CEMConf(scale=4), device=args.device), 1, 4
    return ExplorationSession(g, cem, lr_img, num_latent_channels=nz, scale=scale, n_steps=args.n_steps), scale


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--lr_size", type=int, default=64, help="LR image px")
    parser.add_argument("--regions", type=int, nargs="+", default=[10, 24, 64],
                        help="LR-space region sizes to click (each maps to a crop bucket)")
    parser.add_argument("--n_steps", type=int, default=64, help="steps per search")
    parser.add_argument("--iters", type=int, default=4, help="repeat clicks to time")
    parser.add_argument("--nb", type=int, default=int(os.environ.get("BENCH_NB", 23)))
    parser.add_argument("--opt", default=None, help="optional eval options JSON")
    parser.add_argument("--ckpt", default=None, help="optional generator .pth")
    parser.add_argument("--alternatives", type=int, default=0, help="also time K alternatives (0 = skip)")
    parser.add_argument("--adaptive", action="store_true", default=True)
    parser.add_argument("--no-adaptive", dest="adaptive", action="store_false")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    sess, scale = _session(args)
    hr = args.lr_size * scale

    render_first = _timed(sess.current_sr)
    renders = []
    for _ in range(max(2, args.iters // 2)):
        sess._sr_cache = None
        renders.append(_timed(sess.current_sr))

    clicks = []
    for r in args.regions:
        r = min(r, args.lr_size)
        sess.select_rect(0, 0, r * scale, r * scale)
        first_s = _timed(sess.increase_variance)
        click_s = statistics.median(_timed(sess.increase_variance) for _ in range(args.iters))
        clicks.append({"region_lr": r, "first_s": first_s, "click_s": click_s,
                       "steps_per_s": args.n_steps / click_s})
        print(f"[region {r}] {clicks[-1]}", flush=True)

    y1 = min(args.regions[0], args.lr_size) * scale
    adaptive = None
    if args.adaptive:
        sess.select_rect(0, 0, y1, y1)
        target = np.zeros((hr, hr, 3), np.float32)  # a full-size HR target; the search crops it
        target[::8] = 1.0
        first = _timed(lambda: sess.imprint(target))
        sess.undo()
        repeat = _timed(lambda: sess.imprint(target))
        adaptive = {"first_s": first, "repeat_s": repeat, "rounds": len(sess.last_rounds or [])}
        print(f"[adaptive imprint] {adaptive}", flush=True)

    alternatives = None
    if args.alternatives:
        sess.select_rect(0, 0, y1, y1)
        first = _timed(lambda: sess.propose_alternatives(k=args.alternatives, seed=0))
        repeat = _timed(lambda: sess.propose_alternatives(k=args.alternatives, seed=1))
        alternatives = {"k": args.alternatives, "first_s": first, "repeat_s": repeat}
        print(f"[alternatives k={args.alternatives}] {alternatives}", flush=True)

    dev = sess.device
    line = {
        "metric": "explore_click_latency",
        "unit": "s/tool-click",
        "value": clicks[0]["click_s"] if clicks else None,
        "n_steps": args.n_steps,
        "lr_size": args.lr_size,
        "nb": args.nb,
        "clicks": clicks,
        "render_s": {"first": render_first, "repeat": statistics.median(renders)},
        "adaptive_imprint": adaptive,
        "alternatives": alternatives,
        "platform": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "checkpoint": bool(args.ckpt),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
