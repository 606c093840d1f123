"""Evaluation entry point (port of esr_tpu/test.py)::

    python -m esr_tpu_torch.test -opt esr_tpu_torch/options/test/test_explorable.json \
        [--save_images] [--estimate_kernel [ITERS]] [--device cuda|cpu]

Per test dataset: forward without autograd, optionally save SR PNGs, log the
average PSNR/SSIM (uint8 domain, Y channel unless ``psnr_on_y: false``,
border crop = scale) and the CEM consistency residual; explorable models are
also run with ``num_random_Z`` random Z draws, every draw scored (PSNR, SSIM,
CEM residual), and the output diversity reported plain and texture-masked.

``eval_batch: B`` (> 1) batches same-shape images B at a time (the last
image repeated to fill a batch); ``eval_pad_bucket: K`` edge-pads LR to a
multiple of K and crops SR back; ``self_ensemble: true`` runs the x8
dihedral mean. Metrics of the batched and the serial path are the same
numbers: Z draws are a pure function of (image index, draw index). Runs on
CUDA unless ``--device cpu``.

Blind eval (``--estimate_kernel [ITERS]``, or ``estimate_kernel: true|ITERS``
in a dataset block): the downsampling kernel is estimated (KernelGAN-style,
``esr_tpu_torch.cem.kernelgan``, ITERS iterations, 2000 by default) from
each such dataset's first LR image, and the dataset is evaluated by a model
whose CEM (and LR assumptions) use that kernel; ``opt['kernel']`` is
restored after, so later datasets keep their own.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from esr_tpu_torch.data import create_dataloader, create_dataset
from esr_tpu_torch.data.util import save_img
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.models import create_model
from esr_tpu_torch.ops.color import rgb2ycbcr, tensor2img, to_uint8
from esr_tpu_torch.ops.metrics import calculate_psnr, calculate_ssim, crop_border
from esr_tpu_torch.options import parse
from esr_tpu_torch.utils import mkdirs, setup_logger
from esr_tpu_torch.utils.watchdog import arm_from_opt

__all__ = ["evaluate_dataset", "main"]


def main(argv=None) -> dict:
    """Run the CLI; returns {dataset name: averaged metrics}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True, help="path to options JSON")
    parser.add_argument("--save_images", action="store_true")
    parser.add_argument("--estimate_kernel", nargs="?", const=2000, type=int, default=None,
                        metavar="ITERS", help="blind eval: estimate the downsampling kernel from each "
                        "test dataset's first LR image (ITERS estimator iterations, default 2000) and "
                        "evaluate with CEM under it")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    opt = parse(args.opt, is_train=False)
    if opt.get("eval_precision") == "highest":
        # full f32 in matmuls and cuDNN convs (the f32 plain paths)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mkdirs([opt["path"]["results_root"], opt["path"]["log"]])
    setup_logger("base", opt["path"]["log"], "test", screen=True)
    logger = logging.getLogger("base")
    wd = arm_from_opt(opt.get("watchdog"), opt.get("watchdog_factor"), logger, label="eval")

    base_model = None  # built once; a blind dataset gets a model of its own
    out = {}
    try:
        for phase, dataset_opt in sorted((opt["datasets"] or {}).items()):
            test_set = create_dataset(dataset_opt)
            test_loader = create_dataloader(test_set, dataset_opt)
            name = dataset_opt.get("name") or phase
            est = args.estimate_kernel if args.estimate_kernel is not None else dataset_opt.get("estimate_kernel")
            if est:
                model = _blind_model(opt, test_set, est, logger, device, wd=wd)
            else:
                base_model = base_model or create_model(opt, device=device)
                model = base_model
            logger.info(f"testing [{name}]: {len(test_set)} images")
            save_dir = os.path.join(opt["path"]["results_root"], name) if args.save_images else None
            results = evaluate_dataset(model, test_loader, opt, save_dir=save_dir, wd=wd)
            out[name] = results
            msg = f"[{name}] avg PSNR: {results['psnr']:.4f} dB, avg SSIM: {results['ssim']:.4f}"
            if "cem_residual" in results:
                msg += f", CEM residual max: {results['cem_residual']:.3e}"
            if "z_psnr_mean" in results:
                msg += (f", random-Z PSNR: {results['z_psnr_mean']:.4f} dB"
                        f" (spread {results['z_psnr_spread']:.4f})"
                        f", SSIM: {results['z_ssim_mean']:.4f}")
            if "z_diversity" in results:
                msg += (f", Z diversity: {results['z_diversity']:.4f}"
                        f" (textured {results['z_diversity_textured']:.4f})")
            logger.info(msg)
            if wd is not None:
                wd.beat(count=False)  # dataset boundary: reset the silence clock
    finally:
        if wd is not None:
            wd.stop()
    return out


def _blind_model(opt: dict, test_set, est, logger, device, wd=None):
    """The model of a blind dataset: the kernel estimated from the dataset's
    first LR image (``est``: True for 2000 iterations, else the count), set
    as ``opt['kernel']`` while the model is built, then restored."""
    from esr_tpu_torch.cem.kernelgan import conf_for_image, estimate_kernel

    lr0 = np.asarray(test_set[0]["LR"])
    iters = 2000 if est is True else int(est)
    conf = conf_for_image(lr0.shape, int(opt.get("scale") or 4), iters)
    logger.info(f"blind eval: estimating kernel from the first LR image ({conf.iters} iters, "
                f"g_input {conf.g_input})...")
    progress = None
    if wd is not None:  # a finished chunk is progress, not an image time
        progress = lambda done, total, m: wd.beat(count=False)  # noqa: E731
    kernel, metrics = estimate_kernel(lr0, conf, progress=progress, device=device)
    logger.info("estimated kernel: support %dx%d, l_g %.4f" % (*kernel.shape, metrics["l_g"]))
    if not opt.get("use_cem"):
        logger.info("note: use_cem is false — the estimated kernel affects nothing; "
                    "set use_cem: true for consistency under it")
    prev = opt.get("kernel")
    opt["kernel"] = kernel
    try:
        return create_model(opt, device=device)
    finally:
        opt["kernel"] = prev


def _local_std_map(gray: np.ndarray, window: int = 7) -> np.ndarray:
    """Local std of a 2D array via box filters (integral images)."""
    pad = window // 2
    g = np.pad(gray.astype(np.float64), pad, mode="edge")

    def box(a):
        c = np.cumsum(np.cumsum(a, 0), 1)
        c = np.pad(c, ((1, 0), (1, 0)))
        return (
            c[window:, window:] - c[:-window, window:] - c[window:, :-window] + c[:-window, :-window]
        ) / (window * window)

    mu = box(g)
    var = np.maximum(box(g * g) - mu * mu, 0.0)
    return np.sqrt(var)


class _EvalScorer:
    """Per-image metric accumulation shared by the serial and batched eval
    paths (identical math by construction)."""

    def __init__(self, only_y: bool, scale: int, save_dir: str | None, n_draws: int | None = None):
        self.only_y, self.scale, self.save_dir = only_y, scale, save_dir
        self.psnrs, self.ssims, self.residuals = [], [], []
        self.z_psnrs, self.z_ssims = [], []
        self._z_srs: dict[object, list[np.ndarray]] = {}  # image key -> SRs per draw
        # draws per image (when known): add() scores and drops an image's SRs
        # when its last draw lands instead of holding every draw until finalize()
        self._n_draws = n_draws
        self._z_div_pairs: list[tuple[float, float]] = []  # (plain, textured)

    def add(self, key, zi, sr_img, hr_img, residual, lr_path, multi_z: bool) -> None:
        """sr_img/hr_img: uint8 HWC (already cropped to the original size)."""
        if residual is not None:
            self.residuals.append(float(residual))
        if self.save_dir:
            base = os.path.splitext(os.path.basename(str(lr_path)))[0]
            save_img(sr_img, os.path.join(self.save_dir, f"{base}{'_z%d' % zi if zi else ''}.png"))
        if multi_z:
            srs = self._z_srs.setdefault(key, [])
            srs.append(sr_img)
            if self._n_draws is not None and len(srs) == self._n_draws:
                pair = self._image_diversity(srs)
                if pair is not None:
                    self._z_div_pairs.append(pair)
                del self._z_srs[key]
        if hr_img is None:
            return
        a, b = sr_img, hr_img
        if self.only_y and a.ndim == 3 and a.shape[2] == 3:
            a, b = rgb2ycbcr(a, only_y=True), rgb2ycbcr(b, only_y=True)
        a = crop_border(a, self.scale).astype(np.float64)
        b = crop_border(b, self.scale).astype(np.float64)
        if zi == 0:
            self.psnrs.append(calculate_psnr(a, b))
            self.ssims.append(calculate_ssim(a, b))
        else:  # every random Z draw is scored
            self.z_psnrs.append(calculate_psnr(a, b))
            self.z_ssims.append(calculate_ssim(a, b))

    @staticmethod
    def _image_diversity(srs: list[np.ndarray]) -> tuple[float, float] | None:
        """(plain, textured) mean pairwise L1 across one image's Z draws. The
        texture mask is from the zi=0 SR: pixels whose local std is above the
        image median."""
        if len(srs) < 2:
            return None
        gray = srs[0].astype(np.float64).mean(axis=-1) if srs[0].ndim == 3 else srs[0]
        std = _local_std_map(gray)
        mask = std > np.median(std)
        plain, tex = [], []
        for i in range(len(srs)):
            for j in range(i + 1, len(srs)):
                d = np.abs(srs[i].astype(np.float64) - srs[j].astype(np.float64))
                plain.append(float(d.mean()))
                dm = d.mean(axis=-1) if d.ndim == 3 else d
                tex.append(float(dm[mask].mean()) if mask.any() else 0.0)
        return float(np.mean(plain)), float(np.mean(tex))

    def finalize(self) -> dict:
        pairs = list(self._z_div_pairs)
        for srs in self._z_srs.values():  # images not flushed by add()
            pair = self._image_diversity(srs)
            if pair is not None:
                pairs.append(pair)
        out = {
            "psnr": float(np.mean(self.psnrs)) if self.psnrs else float("nan"),
            "ssim": float(np.mean(self.ssims)) if self.ssims else float("nan"),
        }
        if self.residuals:
            out["cem_residual"] = float(np.max(self.residuals))
        if self.z_psnrs:
            out["z_psnr_mean"] = float(np.mean(self.z_psnrs))
            out["z_psnr_spread"] = float(np.max(self.z_psnrs) - np.min(self.z_psnrs))
            out["z_ssim_mean"] = float(np.mean(self.z_ssims))
        if pairs:
            out["z_diversity"] = float(np.mean([p[0] for p in pairs]))
            out["z_diversity_textured"] = float(np.mean([p[1] for p in pairs]))
        return out


def _pad_to_bucket(lr: np.ndarray, bucket: int):
    """Edge-pad HWC LR to a multiple of ``bucket``; returns (padded, orig_hw
    or None)."""
    if not bucket:
        return lr, None
    h0, w0 = lr.shape[:2]
    hp, wp = -(-h0 // bucket) * bucket, -(-w0 // bucket) * bucket
    if (hp, wp) == (h0, w0):
        return lr, None
    return np.pad(lr, ((0, hp - h0), (0, wp - w0), (0, 0)), mode="edge"), (h0, w0)


def _eval_z_draw(idx: int, k: int, spatial: tuple, nz: int) -> np.ndarray:
    """Deterministic random-Z draw #k (1-based zi = k+1) for image #idx —
    a pure function of (idx, k) so serial and dist/batched eval produce
    bit-identical draws without materializing all maps up front."""
    return np.random.default_rng((7, idx, k)).uniform(
        -1, 1, tuple(spatial) + (nz,)
    ).astype(np.float32)


def _first(batch: dict) -> dict:
    """The single sample of a batch-1 loader batch."""
    return {k: (v[0] if isinstance(v, (np.ndarray, list)) else v) for k, v in batch.items()}


def _sr_image(sr: np.ndarray, orig_hw, scale: int) -> np.ndarray:
    """A uint8 SR image as scored and saved: single channel squeezed, cropped
    back to the unpadded LR times scale."""
    if sr.ndim == 3 and sr.shape[-1] == 1:
        sr = sr[..., 0]
    if orig_hw is not None:
        sr = sr[: orig_hw[0] * scale, : orig_hw[1] * scale]
    return sr


def evaluate_dataset(model, loader, opt, save_dir=None, num_random_z: int | None = None,
                     dist=None, wd=None) -> dict:
    """Shared eval loop (also used by the tests). Returns averaged metrics.

    ``eval_batch`` > 1, or ``dist_eval`` (``dist``) on a single device, runs
    the batched evaluator: images grouped by padded shape, ``eval_batch``
    at a time."""
    scale = int(opt.get("scale") or 4)
    only_y = bool(opt.get("psnr_on_y", True))
    num_z = num_random_z if num_random_z is not None else int(opt.get("num_random_Z") or 0)
    bucket = int(opt.get("eval_pad_bucket") or 0)
    nz = getattr(model, "nz", 0)
    use_dist = bool(opt.get("dist_eval")) if dist is None else bool(dist)
    eval_batch = int(opt.get("eval_batch") or 0)
    if use_dist or eval_batch > 1:
        if use_dist and model.eval_devices() > 1:
            raise NotImplementedError(
                "dist_eval over several devices is not ported yet (ROADMAP.md Queue 1 item 10)")
        return _evaluate_dataset_batched(model, loader, scale=scale, only_y=only_y, num_z=num_z,
                                         bucket=bucket, nz=nz, save_dir=save_dir,
                                         batch=max(1, eval_batch), wd=wd)
    scorer = _EvalScorer(only_y, scale, save_dir, n_draws=1 + (num_z if nz else 0))
    cem = getattr(model, "cem", None)
    for idx, batch in enumerate(loader):
        sample = _first(batch)
        lr_p, orig_hw = _pad_to_bucket(sample["LR"], bucket)
        sample["LR"] = lr_p
        z_draws = [None]
        if nz and num_z:
            # per-image per-draw seeded draws (not one sequential stream), so
            # the batched evaluator, which visits images by shape, draws the same
            z_draws += [_eval_z_draw(idx, k, lr_p.shape[:-1], nz) for k in range(num_z)]
        for zi, z in enumerate(z_draws):
            model.feed_data(sample)
            model.test(z=z) if nz else model.test()
            vis = model.get_visuals_device()
            residual = None
            if cem is not None:
                # consistency of every Z draw, on the device, before the crop
                # (w.r.t. the padded LR actually fed)
                residual = (cem.downsample(vis["SR"][None].float()) - vis["LR"][None]).abs().max().item()
            sr_img = _sr_image(to_uint8(vis["SR"]).cpu().numpy(), orig_hw, scale)
            hr_img = tensor2img(np.asarray(vis["HR"])) if "HR" in vis else None
            scorer.add(idx, zi, sr_img, hr_img, residual, sample.get("LR_path"),
                       multi_z=len(z_draws) > 1)
        if wd is not None:
            wd.beat()  # one beat per scored image
    return scorer.finalize()


def _evaluate_dataset_batched(model, loader, *, scale, only_y, num_z, bucket, nz, save_dir,
                              batch: int, wd=None) -> dict:
    """Batched evaluator (port of the single-device case of the JAX
    package's ``_evaluate_dataset_dist``): images grouped by padded shape,
    ``batch`` at a time, the last image repeated to fill a batch (a group
    smaller than ``batch`` runs at its own size); the same scorer and Z
    draws as the serial path; one uint8 device-to-host copy per batch and
    draw."""
    items = []  # (idx, lr_padded, orig_hw, hr, lr_path)
    for idx, b in enumerate(loader):
        sample = _first(b)
        lr_p, orig_hw = _pad_to_bucket(sample["LR"], bucket)
        items.append((idx, lr_p, orig_hw, sample.get("HR"), sample.get("LR_path")))

    n_draws = 1 + (num_z if nz else 0)
    scorer = _EvalScorer(only_y, scale, save_dir, n_draws=n_draws)
    fwd, cem, device = model._forward, getattr(model, "cem", None), model.device
    by_shape: dict[tuple, list] = {}
    for it in items:
        by_shape.setdefault(it[1].shape, []).append(it)

    for group in by_shape.values():
        chunk_n = min(batch, len(group))
        for lo in range(0, len(group), chunk_n):
            chunk = group[lo : lo + chunk_n]
            pad_n = chunk_n - len(chunk)  # repeat the last image to fill the batch
            lr = torch.from_numpy(np.stack([c[1] for c in chunk] + [chunk[-1][1]] * pad_n)).to(device)
            for zi in range(n_draws):
                z = None
                if nz:
                    zero = np.zeros(chunk[-1][1].shape[:-1] + (nz,), np.float32)
                    z = np.stack([_eval_z_draw(c[0], zi - 1, c[1].shape[:-1], nz) if zi > 0 else zero
                                  for c in chunk] + [zero] * pad_n)
                    z = torch.from_numpy(z).to(device)
                sr = fwd(lr, z)
                res = None
                if cem is not None:
                    res = (cem.downsample(sr.float()) - lr).abs().amax(dim=(1, 2, 3)).cpu().numpy()
                sr_host = to_uint8(sr).cpu().numpy()
                for bi, (idx, _, orig_hw, hr, lr_path) in enumerate(chunk):
                    hr_img = None
                    if hr is not None:
                        hr_arr = np.asarray(hr)
                        hr_img = tensor2img(hr_arr[0] if hr_arr.ndim == 4 else hr_arr)
                    scorer.add(idx, zi, _sr_image(sr_host[bi], orig_hw, scale), hr_img,
                               res[bi] if res is not None else None, lr_path, multi_z=n_draws > 1)
            if wd is not None:
                wd.beat()  # one beat per batch
    return scorer.finalize()


if __name__ == "__main__":
    main()
