"""Interactive exploration CLI (port of esr_tpu/explore/cli.py): the
editor's workflow in a terminal; the Qt front-end in
``esr_tpu_torch.explore.gui`` drives the same view-model.

Usage::

    python -m esr_tpu_torch.explore.cli -opt OPTIONS.json --lr image.png [--device cpu] \
        [--estimate_kernel [ITERS]]   # blind SR: estimate the kernel from
                                      # image.png, CEM under it

It runs on CUDA unless ``--device cpu`` is given.

Commands (one per line)::

    select y0 x0 y1 x1        # HR-space rectangle
    polygon y x y x ...       # HR-space polygon selection (>=3 vertices)
    clear                     # clear the selection
    variance +|-              # increase / decrease local variance
    realism +|-               # push D realism score up / down (needs a D —
                              # loaded from path.pretrain_model_D when set)
    dscore                    # print the region's current D realism score
    brightness LEVEL          # 0..1 target mean
    smooth                    # TV smoothing
    periodicity PY PX         # encourage periodicity (pixels; 0 = off)
    imprint PATH              # L1-imprint an image file over the region
    text WORDS...             # imprint rendered text (graffiti) in-region
    histogram PATH            # transfer an image's intensity distribution
    alternatives K            # propose K diverse candidates (none applied)
    pick I                    # apply proposed candidate I
    steps N                   # Z-search steps per tool run (search strength)
    zmax R                    # adaptive tools' z-range escalation ceiling
                              # (0 = stay inside the trained latent box)
    undo / redo / reset       # Z history ops
    zmap PATH                 # save a Z-map visualization png
    save PATH                 # write current SR png
    savez PATH                # write session state (npz)
    loadz PATH                # load session state
    quit
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_session_from_opt(opt_path, lr_path: str, estimate_kernel_iters=None, device="cuda"):
    """The flagship editor's session from an eval options file (a path or a
    dict) and an LR image: the model's generator (``path.pretrain_model_G``)
    and CEM on ``device``, and the discriminator of ``path.pretrain_model_D``
    when set, for the realism tool. ``estimate_kernel_iters``: blind SR, the
    downsampling kernel estimated from the LR image itself in that many
    iterations (``esr_tpu_torch.cem.kernelgan``) and CEM run under it."""
    from esr_tpu_torch.data.util import read_img
    from esr_tpu_torch.explore.session import ExplorationSession
    from esr_tpu_torch.models import create_model
    from esr_tpu_torch.options import parse

    opt = parse(opt_path, is_train=False)
    lr_host = read_img(lr_path)
    if estimate_kernel_iters:
        from esr_tpu_torch.cem.kernelgan import conf_for_image, estimate_kernel

        conf = conf_for_image(lr_host.shape, int(opt.get("scale") or 4), int(estimate_kernel_iters))
        print(f"estimating kernel from {lr_path} ({conf.iters} iters, g_input {conf.g_input})...", flush=True)
        opt["kernel"], _ = estimate_kernel(lr_host, conf, device=device)
        if not opt.get("use_cem"):
            print("note: use_cem is false — the estimated kernel affects nothing; "
                  "set use_cem: true for consistency under it", flush=True)
    model = create_model(opt, device=device)
    sess = ExplorationSession(model.g_module, model.cem, lr_host[None],
                              num_latent_channels=model.nz or 1, scale=int(opt.get("scale") or 4))
    d_path = (opt.get("path") or {}).get("pretrain_model_D")
    if d_path:
        sess.set_discriminator(load_discriminator(model, opt, d_path))
    return sess


def load_discriminator(model, opt: dict, path: str):
    """``DiscriminatorVGG128`` from ``define_D`` with the width and head size of
    the checkpoint at ``path`` (an eval options file may carry no
    ``network_D`` block or train crop), loaded strictly into it with
    ``BaseModel._load_module`` (``load_network`` loads into G)."""
    from esr_tpu_torch.models import define_D

    state = torch.load(path, map_location="cpu", weights_only=True)
    net_d = dict(opt.get("network_D") or {})
    nf = infer_d_nf(state, int(net_d.get("nf") or 64))
    lin_in = int(state["linear1.weight"].shape[1]) if "linear1.weight" in state else nf * 8 * 16
    hr_size = round((lin_in / (nf * 8)) ** 0.5) * 32
    d_opt = {"network_D": dict(net_d, nf=nf), "datasets": {"train": {"HR_size": hr_size}},
             "bf16": opt.get("bf16", True)}
    d = define_D(d_opt, device=model.device)
    model._load_module(d, path)
    return d.eval()


def infer_d_nf(state: dict, default: int = 64) -> int:
    """D's width from the checkpoint's first conv (``conv0_0.weight``, OIHW:
    (nf, 3, 3, 3)), so an eval opt without a ``network_D`` block, or with a
    stale ``nf``, still loads the D it was trained with."""
    try:
        return int(state["conv0_0.weight"].shape[0])
    except (KeyError, AttributeError, TypeError, IndexError):
        return int(default)


def _get_vm(sess):
    """One EditorViewModel per session: the CLI and the Qt GUI drive the same
    editor surface."""
    from esr_tpu_torch.explore.viewmodel import EditorViewModel

    if isinstance(sess, EditorViewModel):
        return sess
    if not hasattr(sess, "_cli_vm"):
        sess._cli_vm = EditorViewModel(sess)
    return sess._cli_vm


def run_command(sess, line: str) -> str:
    """Execute one editor command; returns a status string ('' = quit).
    Malformed arguments report usage instead of raising."""
    parts = line.strip().split()
    if not parts:
        return "noop"
    cmd, args = parts[0].lower(), parts[1:]
    if cmd == "quit":
        return ""
    try:
        return _dispatch(_get_vm(sess), cmd, args)
    except (IndexError, ValueError, FileNotFoundError) as e:
        return f"bad arguments for '{cmd}' ({e}); see module docstring for usage"


def _dispatch(vm, cmd: str, args: list[str]) -> str:
    from esr_tpu_torch.data.util import read_img, save_img

    sess = vm.session
    if cmd == "select":
        y0, x0, y1, x1 = map(int, args)
        sess.select_rect(y0, x0, y1, x1)
        return f"selected rect {(y0, x0, y1, x1)}"
    if cmd == "polygon":
        coords = list(map(int, args))
        if len(coords) < 6 or len(coords) % 2:
            raise ValueError("need >=3 (y, x) vertex pairs")
        vm.set_selection_mode("polygon")
        for y, x in zip(coords[::2], coords[1::2]):
            vm.pointer_down(y, x)
        return vm.finish_polygon()
    if cmd == "clear":
        return vm.clear_selection()
    if cmd == "steps":
        return vm.set_search_steps(int(args[0]))
    if cmd == "zmax":
        return vm.set_z_range_max(float(args[0]))
    if cmd == "variance":
        if not args or args[0] not in ("+", "-"):
            raise ValueError("usage: variance +|-")
        return vm.variance(+1 if args[0] == "+" else -1)
    if cmd == "realism":
        if not args or args[0] not in ("+", "-"):
            raise ValueError("usage: realism +|-")
        return vm.realism(+1 if args[0] == "+" else -1)
    if cmd == "dscore":
        return f"D realism score: {sess.d_score():+.4f}"
    if cmd == "brightness":
        return vm.brightness(float(args[0]))
    if cmd == "smooth":
        return vm.smooth()
    if cmd == "periodicity":
        return vm.periodicity(float(args[0]), float(args[1]))
    if cmd == "imprint":
        return vm.imprint_image(read_img(args[0]).astype(np.float32))
    if cmd == "text":
        if not args:
            raise ValueError("need text to imprint")
        return vm.imprint_text(" ".join(args))
    if cmd == "histogram":
        return vm.match_histogram(read_img(args[0]))
    if cmd == "alternatives":
        return vm.generate_alternatives(k=int(args[0]) if args else 3)
    if cmd == "pick":
        return vm.pick_alternative(int(args[0]))
    if cmd == "undo":
        return vm.undo()
    if cmd == "redo":
        return vm.redo()
    if cmd == "reset":
        return vm.reset_region()
    if cmd == "zmap":
        save_img(vm.zmap_image(), args[0])
        return f"z-map saved {args[0]}"
    if cmd == "save":
        vm.save_image(args[0])
        return f"saved {args[0]}"
    if cmd == "savez":
        vm.save_session(args[0])
        return f"state saved {args[0]}"
    if cmd == "loadz":
        return vm.load_session(args[0])
    return f"unknown command: {cmd}"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True)
    parser.add_argument("--lr", required=True, help="LR input image path")
    parser.add_argument("--estimate_kernel", nargs="?", const=2000, type=int, default=None,
                        help="blind SR: estimate the downsampling kernel from the LR image "
                        "(ITERS estimator iterations, default 2000) and run CEM under it")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    sess = build_session_from_opt(args.opt, args.lr, args.estimate_kernel, device=args.device)
    print("explorable-SR editor; 'quit' to exit", flush=True)
    for line in sys.stdin:
        msg = run_command(sess, line)
        if not msg:
            break
        print(msg, flush=True)


if __name__ == "__main__":
    main()
