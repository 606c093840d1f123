"""Test-time Z-map optimization (port of esr_tpu/explore/z_optimizer.py).

Given a frozen, CEM-wrapped generator ``forward(lr, z) -> sr`` and an
objective over a region, search the latent Z map that minimizes it: Adam on
Z (optax's ``adam``: b1 0.9, b2 0.999, eps 1e-8, ``m_hat / (sqrt(v_hat) +
eps)``; ``models.base_model.Adam`` on the one tensor), Z clipped to
``[-z_range, z_range]`` after each update. The JAX package runs the whole
search as one ``lax.scan`` program; here it is a Python loop whose Z, Adam
moments and best-so-far Z stay on the device, and whose loss trace is
fetched once per chunk (a chunk is the whole search unless progress is
reported), not once per step.

Region handling: the LR-space bounding box of the selection is rounded up to
a bucketed square crop (:func:`bucket_crop`), and the search runs on that
crop of LR, Z, the HR mask and the objective's HR-space images, then pastes
the crop's Z back.

One deliberate divergence: with ``max_rounds=None`` the reference sizes the
adaptive search's round budget with ``log(lr_boost)`` and
``log(z_range_boost)``, which divide by zero at a boost of 1. Here a boost of
1 or less is a ladder of no rounds (and is never climbed).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from esr_tpu_torch.explore.objectives import Objective
from esr_tpu_torch.models.base_model import Adam

__all__ = ["ZOptimizer", "bucket_crop", "optimize_z", "optimize_z_adaptive"]

_BUCKETS = (16, 32, 64, 128, 256)


def bucket_crop(box: tuple[int, int, int, int], h: int, w: int, scale: int, buckets=_BUCKETS):
    """Round an LR-space region box (y0, x0, y1, x1) up to a bucketed square
    crop within the image. Returns (y, x, size) in LR coordinates."""
    y0, x0, y1, x1 = box
    need = max(y1 - y0, x1 - x0)
    size = next((b for b in buckets if b >= need), max(h, w))
    size = min(size, min(h, w))
    y = min(max(0, (y0 + y1 - size) // 2), h - size)
    x = min(max(0, (x0 + x1 - size) // 2), w - size)
    return y, x, size


def _as_fn_aux(objective):
    if isinstance(objective, Objective):
        return objective.fn, objective.aux or {}
    return (lambda sr, mask, aux: objective(sr, mask)), {}


def _decayed(lr: float, lr_decay: float, total_steps: int):
    """optax ``exponential_decay(lr, total_steps, lr_decay)``, not staircase,
    read at the count of updates made so far (the first update takes ``lr``)."""
    if lr_decay == 1.0:
        return lambda count: lr
    steps = max(total_steps, 1)
    return lambda count: float(np.float32(lr) * np.float32(lr_decay) ** np.float32(count / steps))


def _loss_and_grad(forward, lr_img, z, mask, fn, aux):
    zl = z.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = fn(forward(lr_img, zl), mask, aux)
        (g,) = torch.autograd.grad(loss, zl)
    return loss.detach(), g


def _run_steps(forward, lr_img, z, opt: Adam, mask, fn, aux, n_steps: int, lr_at, z_range, best=None):
    """``n_steps`` Adam steps on the buffer ``z`` (updated in place, as
    ``opt`` holds it). Returns the step losses as a device tensor; with
    ``best`` = [best_z, best_loss] (device tensors), the best Z evaluated and
    its loss are tracked there."""
    losses = []
    for _ in range(n_steps):
        loss, g = _loss_and_grad(forward, lr_img, z, mask, fn, aux)
        if best is not None:
            better = loss < best[1]
            best[0] = torch.where(better, z, best[0])
            best[1] = torch.minimum(loss, best[1])
        opt.step([g], lr_at(opt.count))
        if z_range:
            z.clamp_(-z_range, z_range)
        losses.append(loss)
    return torch.stack(losses)


def optimize_z(forward, lr_img, z0, mask_hr, objective, n_steps: int = 100, lr: float = 0.1,
               z_range: float = 1.0, lr_decay: float = 1.0, progress_cb=None, n_chunks: int = 1):
    """Search Z from ``z0`` for ``objective`` (an :class:`Objective` or a plain
    ``f(sr, mask)``) over ``n_steps`` Adam steps; ``lr_decay`` < 1 decays the
    LR exponentially to ``lr * lr_decay`` by the end. Returns (z, loss trace
    as a numpy array).

    ``progress_cb(done_steps, total_steps, losses_so_far)``: when given (or
    ``n_chunks`` > 1), the steps run in ``n_chunks`` chunks with Z and the
    Adam state carried across (the same steps), and the callback fires at
    each chunk's end."""
    fn, aux = _as_fn_aux(objective)
    z = z0.detach().clone()
    opt = Adam([z])
    lr_at = _decayed(lr, lr_decay, n_steps)
    n_chunks = 1 if progress_cb is None and n_chunks <= 1 else max(1, min(int(n_chunks), n_steps))
    bounds = np.linspace(0, n_steps, n_chunks + 1).astype(int)
    losses = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        chunk = _run_steps(forward, lr_img, z, opt, mask_hr, fn, aux, int(hi - lo), lr_at, z_range)
        losses.append(chunk.cpu().numpy())
        if progress_cb is not None:
            progress_cb(int(hi), int(n_steps), np.concatenate(losses))
    return z, np.concatenate(losses) if losses else np.zeros((0,), np.float32)


def _ladder_rounds(cur: float, top: float, boost: float) -> int:
    """Rounds a ladder climbs from ``cur`` to ``top`` by ``boost``; none when
    there is nothing to climb or the boost is 1 or less."""
    if not (math.isfinite(cur) and math.isfinite(top)) or cur >= top or boost <= 1.0:
        return 0
    return max(0, math.ceil(math.log(top / cur) / math.log(boost) - 1e-9))


def optimize_z_adaptive(forward, lr_img, z0, mask_hr, objective, n_steps: int = 64, lr: float = 0.1,
                        z_range: float = 1.0, max_rounds: int | None = None, plateau_rel: float = 0.02,
                        lr_boost: float = 3.0, lr_max: float = 2.7, z_range_boost: float = 1.75,
                        z_range_max: float | None = None, progress_cb=None):
    """Plateau-escalating Z search: rounds of ``n_steps`` with Z and the Adam
    state carried. After a round whose relative improvement ``(first - last)
    / |first|`` is below ``plateau_rel``, the Adam LR is boosted ``x
    lr_boost`` up to ``lr_max``; with the LR ladder done, the Z clip bound is
    widened ``x z_range_boost`` up to ``z_range_max``; a plateau at full
    escalation stops the search. Returns ``(z_best, losses, rounds)``: the
    best Z evaluated anywhere in the search, the loss trace, and per round
    ``{"lr", "z_range", "first", "last", "rel_improvement", "best"}`` (the last
    with ``"stop"``: why the search ended)."""
    fn, aux = _as_fn_aux(objective)
    z = z0.detach().clone()
    opt = Adam([z])
    # z_range 0 / None: unbounded (the round still clips, against inf)
    cur_lr = float(lr)
    cur_zr = float(z_range) if z_range else float("inf")
    zr_max = float(z_range_max) if z_range_max else cur_zr
    if max_rounds is None:
        # the initial round, the two ladders and one settle round at full escalation
        max_rounds = 1 + _ladder_rounds(cur_lr, lr_max, lr_boost) + _ladder_rounds(cur_zr, zr_max, z_range_boost) + 1
    best_z, best_loss = z.clone(), float("inf")
    all_losses, rounds = [], []
    total = max_rounds * n_steps
    stop_reason = None
    for r in range(max_rounds):
        best = [z.clone(), torch.tensor(float("inf"), device=z.device)]
        round_lr = float(np.float32(cur_lr))
        losses = _run_steps(forward, lr_img, z, opt, mask_hr, fn, aux, int(n_steps), lambda count: round_lr,
                            cur_zr if math.isfinite(cur_zr) else None, best)
        losses = losses.cpu().numpy()
        all_losses.append(losses)
        rb_loss = float(best[1])
        if rb_loss < best_loss:
            best_z, best_loss = best[0], rb_loss
        first, last = float(losses[0]), float(losses[-1])
        rel = (first - last) / (abs(first) + 1e-12)
        rounds.append({"lr": cur_lr, "z_range": cur_zr, "first": first, "last": last,
                       "rel_improvement": rel, "best": best_loss})
        if progress_cb is not None:
            progress_cb((r + 1) * n_steps, total, np.concatenate(all_losses))
        if rel < plateau_rel:
            if lr_boost > 1.0 and cur_lr < lr_max * (1 - 1e-6):
                cur_lr = min(cur_lr * lr_boost, lr_max)
            elif z_range_boost > 1.0 and cur_zr < zr_max * (1 - 1e-6):
                # the LR ladder is done: widen the latent box
                cur_zr = min(cur_zr * z_range_boost, zr_max)
            else:
                stop_reason = "insensitive-at-max-escalation"
                break
    if rounds:
        if stop_reason is None:
            stop_reason = ("plateaued-at-round-budget" if rounds[-1]["rel_improvement"] < plateau_rel
                           else "improving-at-round-budget")
        rounds[-1]["stop"] = stop_reason
    return best_z, np.concatenate(all_losses), rounds


class ZOptimizer:
    """Region cropping and paste-back around :func:`optimize_z` (and
    :func:`optimize_z_adaptive`), on ``device``."""

    def __init__(self, forward, scale: int = 4, n_steps: int = 100, lr: float = 0.1, z_range: float = 1.0,
                 crop_to_region: bool = True, lr_decay: float = 1.0, device: str | torch.device = "cuda"):
        self.forward = forward
        self.scale = scale
        self.n_steps = n_steps
        self.lr = lr
        self.z_range = z_range
        self.crop_to_region = crop_to_region
        self.lr_decay = lr_decay
        self.device = torch.device(device)
        self.last_rounds = None  # the adaptive search's escalation report

    def __call__(self, lr_img, z, objective, mask_hr=None, box_lr=None, progress_cb=None, n_chunks: int = 1,
                 adaptive: bool = False, z_range_max: float | None = None):
        """Optimize Z for ``objective`` over the region: ``mask_hr`` (H_hr,
        W_hr) float weights (1 inside), ``box_lr`` the LR-space box that
        enables the bucketed crop. Returns (the full Z map on the device, the
        loss trace)."""
        dev = self.device
        lr_img = torch.as_tensor(np.asarray(lr_img, np.float32) if not isinstance(lr_img, torch.Tensor) else lr_img,
                                 device=dev)
        z = torch.as_tensor(np.asarray(z, np.float32) if not isinstance(z, torch.Tensor) else z, device=dev)
        n, h, w, _ = lr_img.shape
        s = self.scale
        if mask_hr is None:
            mask_hr = np.ones((h * s, w * s), np.float32)
        mask_hr = torch.as_tensor(np.asarray(mask_hr, np.float32) if not isinstance(mask_hr, torch.Tensor)
                                  else mask_hr, dtype=torch.float32, device=dev)
        if isinstance(objective, Objective):
            objective = objective.to(dev)
        self.last_rounds = None

        def search(lr_i, z_i, m_i, objective_i):
            if adaptive:
                z_o, losses, rounds = optimize_z_adaptive(
                    self.forward, lr_i, z_i, m_i, objective_i, n_steps=self.n_steps, lr=self.lr,
                    z_range=self.z_range, z_range_max=z_range_max, progress_cb=progress_cb)
                self.last_rounds = rounds
                return z_o, losses
            return optimize_z(self.forward, lr_i, z_i, m_i, objective_i, n_steps=self.n_steps, lr=self.lr,
                              z_range=self.z_range, lr_decay=self.lr_decay, progress_cb=progress_cb,
                              n_chunks=n_chunks)

        if self.crop_to_region and box_lr is not None:
            y, x, size = bucket_crop(box_lr, h, w, s)
            lr_c = lr_img[:, y : y + size, x : x + size]
            z_c = z[:, y : y + size, x : x + size]
            m_c = mask_hr[y * s : (y + size) * s, x * s : (x + size) * s]
            if isinstance(objective, Objective):
                # HR-space constants (imprint target, anchors) track the crop
                objective = objective.crop_hr(y * s, x * s, size * s)
            z_opt_c, losses = search(lr_c, z_c, m_c, objective)
            z_opt = z.clone()
            z_opt[:, y : y + size, x : x + size] = z_opt_c
            return z_opt, losses
        return search(lr_img, z, mask_hr, objective)
