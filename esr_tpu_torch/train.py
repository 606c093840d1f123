"""Training entry point (port of esr_tpu/train.py)::

    python -m esr_tpu_torch.train -opt esr_tpu_torch/options/train/train_explorable_SR.json \
        [--auto_resume] [--device cuda|cpu]

Parse the options, seed, build the loaders and the model, then per step
``feed_data`` -> ``optimize_parameters`` with the periodic log line (and
``train_metrics.csv``), validation PSNR and checkpoints (``<iter>_G.pth``,
``<iter>_D.pth``, ``<iter>.state``). ``--auto_resume`` continues from the
newest training state and replays the data stream from there
(``set_position``); SIGTERM (a preemption notice) finishes the step in
flight, saves the networks and the training state, and exits cleanly (under
a process group, every rank stops after the first step at which any rank
has seen it). The watchdog (on unless ``train.watchdog: false``) exits 86
when steps stop coming. Runs on CUDA unless ``--device cpu``.

``train.steps_per_dispatch`` k > 1 groups k loader batches into a chunk
(``optimize_parameters_chunk``), as the JAX package does: a chunk never
crosses a print, validation or save step (:func:`chunk_limit`), so the log,
validation and checkpoint cadence is the per-step loop's, and a pending
chunk is trained before the final or preemption save, so a resumed run
replays the same batches. On CUDA in one process each train step is a CUDA
graph's replay, and a chunk replays it k times with nothing on the host in
between but the copies of each step's inputs; on the CPU (or with several
ranks) a chunk runs k eager steps. The trajectory is the per-step loop's.

Under ``torchrun --nproc_per_node N`` (``WORLD_SIZE`` > 1) every rank joins
the process group (``dist_backend``) and trains the options' parallel axes
(``dist``, ``train_tp``, ``train_pp``, ``train_spatial``; see
``models/base_model.py::_train_parallel``): each rank loads its rows of a
data-parallel batch, every rank runs the validation forwards and the
checkpoint gathers, and rank 0 alone logs and writes.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import signal

import numpy as np

from esr_tpu_torch import data as data_mod
from esr_tpu_torch import options as options_mod
from esr_tpu_torch.data.util import save_img
from esr_tpu_torch.models import create_model
from esr_tpu_torch.models.base_model import BaseModel
from esr_tpu_torch.ops.color import rgb2ycbcr
from esr_tpu_torch.ops.metrics import calculate_psnr, crop_border
from esr_tpu_torch.parallel import comm
from esr_tpu_torch.utils import Logger, mkdir_and_rename, mkdirs, set_random_seed, setup_logger
from esr_tpu_torch.utils.watchdog import arm_from_opt

__all__ = ["chunk_limit", "main", "stack_chunk", "validate"]


def chunk_limit(step: int, k: int, freqs, niter: int) -> int:
    """The longest chunk after ``step`` that crosses no event step (a multiple
    of a nonzero freq in ``freqs``) and not ``niter``: at most ``k``, at least 1."""
    limit = niter - step
    for f in freqs:
        if f:
            limit = min(limit, f - step % f)
    return max(1, min(k, limit))


def stack_chunk(batches: list) -> dict:
    """Loader batches (dicts) stacked on a new leading step axis; values that
    are not arrays (path lists) collected into lists."""
    out = {}
    for key in batches[0]:
        vals = [b.get(key) for b in batches]
        out[key] = np.stack(vals) if all(isinstance(v, np.ndarray) for v in vals) else vals
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True, help="path to options JSON")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    opt = options_mod.parse(args.opt, is_train=True)
    # under a launcher (torchrun, WORLD_SIZE > 1) every rank joins the process group
    device = comm.init_from_env(opt, args.device)

    # SIGTERM (preemption) sets a flag: the loop finishes the step in flight,
    # saves, and returns. Installed before the model is built. The loop keeps
    # the ranks' agreed decision apart, in "stop": nothing writes over the flag.
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):  # noqa: ARG001
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        _train(opt, args.auto_resume, device, preempted)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)


def _train(opt, auto_resume: bool, device, preempted: dict) -> None:
    preempted["stop"] = False
    resume_path = opt["path"].get("resume_state")
    if auto_resume and not resume_path:
        resume_path = BaseModel.latest_state_path(opt["path"]["training_state"])
    main_rank = comm.world()[0] == 0
    if resume_path:
        options_mod.check_resume(opt)
    elif main_rank:
        mkdir_and_rename(opt["path"]["experiments_root"])
    if main_rank:
        mkdirs([opt["path"][k] for k in ("models", "training_state", "log", "val_images")])
        setup_logger("base", opt["path"]["log"], "train", screen=True)
        options_mod.save(opt)
    logger = logging.getLogger("base")
    set_random_seed(int((opt["train"] or {}).get("manual_seed") or 0))

    train_loader = val_loader = None
    for phase, dataset_opt in (opt["datasets"] or {}).items():
        if phase.startswith("train"):
            train_set = data_mod.create_dataset(dataset_opt)
            train_loader = data_mod.create_dataloader(train_set, dataset_opt)
            logger.info(f"train dataset [{dataset_opt.get('name')}]: {len(train_set)} images")
        elif phase.startswith("val"):
            val_set = data_mod.create_dataset(dataset_opt)
            val_loader = data_mod.create_dataloader(val_set, dataset_opt)
            logger.info(f"val dataset [{dataset_opt.get('name')}]: {len(val_set)} images")
    if train_loader is None:
        raise ValueError("no train dataset configured")
    if len(train_loader) == 0:
        # drop_last with batch_size > dataset size: zero batches per epoch
        raise ValueError(
            f"train loader yields 0 batches: dataset has {len(train_loader.dataset)} images but batch_size "
            f"is {train_loader.batch_size} (drop_last) — shrink batch_size or add data")

    model = create_model(opt, device=device)
    # data parallelism: this rank loads its rows of each global batch
    train_loader.set_shard(*model.data_shard())
    start_epoch, current_step = 0, 0
    if resume_path:
        start_epoch, current_step = model.resume_training(resume_path)
        logger.info(f"resumed from {resume_path} (epoch {start_epoch}, iter {current_step})")
        offset = current_step - start_epoch * len(train_loader)
        if not 0 <= offset <= len(train_loader):
            # an epoch record out of line with the step count: the step count
            # is the number of batches consumed
            start_epoch = current_step // len(train_loader)
            offset = current_step - start_epoch * len(train_loader)
            logger.info(f"re-aligned resume position to epoch {start_epoch}")
        train_loader.set_position(start_epoch, offset)

    train_opt, log_opt = opt["train"], opt["logger"] or {}
    niter = int(train_opt.get("niter") or 100000)
    val_freq = int(train_opt.get("val_freq") or 5000)
    print_freq = int(log_opt.get("print_freq") or 100)
    save_freq = int(log_opt.get("save_checkpoint_freq") or 5000)
    total_epochs = max(1, math.ceil(niter / len(train_loader)))
    tlogger = Logger(opt) if main_rank else None
    logger.info(f"training for {niter} iters (~{total_epochs} epochs) on {device}")
    k_dispatch = int(train_opt.get("steps_per_dispatch") or 1)
    event_freqs = (print_freq, val_freq if val_loader is not None else 0, save_freq)
    wd = arm_from_opt(train_opt.get("watchdog"), train_opt.get("watchdog_factor"), logger)

    def run(chunk: list, step: int) -> int:
        """Train the pending batches (a chunk of one is a plain step); the new step count."""
        if len(chunk) == 1:
            model.feed_data(chunk[0])
            model.optimize_parameters(step + 1)
        else:
            model.optimize_parameters_chunk(step + 1, stack_chunk(chunk))
        return step + len(chunk)

    epoch = start_epoch
    chunk = []  # batches drawn and not yet trained; kept across epochs
    try:
        for epoch in range(start_epoch, total_epochs + 1):
            for batch in train_loader:
                if current_step >= niter or _stop_requested(preempted):
                    break
                chunk.append(batch)
                if len(chunk) < chunk_limit(current_step, k_dispatch, event_freqs, niter):
                    continue
                current_step, chunk = run(chunk, current_step), []
                if wd is not None:
                    wd.beat(current_step)
                if current_step % print_freq == 0 and tlogger is not None:
                    tlogger.log_scalars(current_step, epoch, model.get_current_learning_rate(),
                                        model.get_current_losses())
                if val_loader is not None and current_step % val_freq == 0:
                    # every rank runs the forwards (a sharded one needs them all); rank 0 logs and writes
                    val = validate(model, val_loader, opt, step=current_step)
                    if tlogger is not None:
                        tlogger.log_validation(current_step, epoch, val)
                    if wd is not None:
                        wd.beat(count=False)  # validation takes longer than a step
                if current_step % save_freq == 0:
                    model.save(current_step)
                    model.save_training(epoch, current_step)
                    logger.info(f"checkpoint saved @ iter {current_step}")
                    if wd is not None:
                        wd.beat(count=False)
            if current_step >= niter or _stop_requested(preempted):
                break
        if chunk:
            # its batches are drawn from the data stream: train them before the save, or a resumed
            # run (set_position) would hand other batches to those steps
            current_step = run(chunk, current_step)
        model.save("latest")
        if preempted["stop"]:
            model.save_training(epoch, current_step)
            logger.info(f"preempted (SIGTERM) — state saved @ iter {current_step}; "
                        "rerun with --auto_resume to continue")
        else:
            model.save_training(total_epochs, current_step)
            logger.info("training complete")
    finally:
        if wd is not None:
            wd.stop()


def _stop_requested(preempted: dict) -> bool:
    """Whether any rank's preemption flag is up (``comm.any_rank``), so that
    every rank stops after the same step and saves with the others: a
    launcher's SIGTERM reaches the ranks at different times. The decision goes
    to ``preempted["stop"]``; a flag raised while the ranks agree is seen at
    the next check. Collective."""
    preempted["stop"] = comm.any_rank(preempted["flag"])
    return preempted["stop"]


def validate(model, val_loader, opt, step=None) -> dict:
    """Mean PSNR over the val set (uint8 domain, border = scale; Y channel with
    ``val_on_y``); with ``step``, rank 0 writes the SR images to ``val_images``."""
    scale = int(opt.get("scale") or 4)
    on_y = bool(opt.get("val_on_y"))
    val_dir = opt["path"].get("val_images") if step is not None and comm.world()[0] == 0 else None
    psnrs = []
    for i, batch in enumerate(val_loader):
        sample = {k: (v[0] if isinstance(v, (np.ndarray, list)) else v) for k, v in batch.items()}
        model.feed_data(sample)
        model.test()
        vis = model.get_visuals_uint8()
        sr_img = vis["SR"]
        if val_dir:
            base = os.path.splitext(os.path.basename(str(sample.get("HR_path") or i)))[0]
            save_img(sr_img, os.path.join(val_dir, base, f"{base}_{step}.png"))
        if "HR" not in vis:
            continue
        a, b = sr_img, vis["HR"]
        if on_y and a.ndim == 3 and a.shape[2] == 3:
            a, b = rgb2ycbcr(a, only_y=True), rgb2ycbcr(b, only_y=True)
        psnrs.append(calculate_psnr(crop_border(a, scale).astype(np.float64),
                                    crop_border(b, scale).astype(np.float64)))
    return {"psnr": float(np.mean(psnrs)) if psnrs else float("nan")}


if __name__ == "__main__":
    main()
