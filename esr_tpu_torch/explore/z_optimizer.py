"""Test-time Z-map optimization (port of esr_tpu/explore/z_optimizer.py).

Given a frozen, CEM-wrapped generator ``forward(lr, z) -> sr`` and an
objective over a region, search the latent Z map that minimizes it: Adam on
Z (optax's ``adam``: b1 0.9, b2 0.999, eps 1e-8, ``m_hat / (sqrt(v_hat) +
eps)``; ``models.base_model.Adam`` on the one tensor), Z clipped to
``[-z_range, z_range]`` after each update. The JAX package runs the whole
search (each round of the adaptive one) as one ``lax.scan`` program; here a
Z step (forward through the frozen generator, CEM, the objective, dloss/dZ,
Adam on Z, the clip, the best-Z update) runs on fixed buffers, and on CUDA it
is a CUDA graph replayed once per step (``utils/graphs.py``): Z, the Adam
moments, the best-so-far Z and the loss trace stay on the device, the step
scalars of a run of steps are uploaded at once, and the trace is fetched
once per chunk (a chunk is the whole search unless progress is reported).
:class:`ZOptimizer` keeps the searches it captured by crop shape and
objective, so a new click of the same tool and bucket copies its images into
the buffers and replays without capturing again.

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
from esr_tpu_torch.utils.graphs import GraphedStep

__all__ = ["ZOptimizer", "ZSearch", "ZSearchCache", "bucket_crop", "optimize_z", "optimize_z_adaptive"]

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


class ZSearch:
    """One Z search on fixed buffers: LR, the mask, the objective's tensors,
    Z and its Adam state, the clip bound, the best Z evaluated and its loss.
    A step is :class:`~esr_tpu_torch.utils.graphs.GraphedStep` (a CUDA graph
    on CUDA, eager on the CPU). :meth:`load` starts a new search on the same
    buffers."""

    def __init__(self, forward, lr_img, z, mask, fn, aux: dict, pool=None):
        self.forward, self.fn = forward, fn
        self.lr_img, self.mask, self.z = lr_img.detach().clone(), mask.detach().clone(), z.detach().clone()
        self.aux = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
        self.opt = Adam([self.z])
        self.z_range = torch.full((), math.inf, device=self.z.device)
        self.best_z = self.z.clone()
        self.best_loss = torch.full((), math.inf, device=self.z.device)
        self.step = GraphedStep(self._step, self.z.device, "Z step", pool=pool)

    def load(self, lr_img, z, mask, aux: dict) -> None:
        """A new search from ``z``: the images copied in, Adam's state zeroed."""
        self.lr_img.copy_(lr_img)
        self.mask.copy_(mask)
        self.z.copy_(z)
        for k, v in aux.items():
            if isinstance(v, torch.Tensor):
                self.aux[k].copy_(v)
        torch._foreach_zero_(self.opt.mu + self.opt.nu)
        self.opt.count = 0

    def set_round(self, z_range) -> None:
        """The clip bound (None / 0: unbounded) and a fresh best-so-far."""
        self.z_range.fill_(float(z_range) if z_range else math.inf)
        self.best_z.copy_(self.z)
        self.best_loss.fill_(math.inf)

    def _step(self) -> torch.Tensor:
        loss, g = _loss_and_grad(self.forward, self.lr_img, self.z, self.mask, self.fn, self.aux)
        self.best_z.copy_(torch.where(loss < self.best_loss, self.z, self.best_z))
        self.best_loss.copy_(torch.minimum(loss, self.best_loss))
        self.opt.step([g])
        self.z.clamp_(-self.z_range, self.z_range)
        return loss

    def run(self, n_steps: int, lr_at) -> torch.Tensor:
        """``n_steps`` Adam steps, each at ``lr_at(count of updates so far)``
        (computed on the host, uploaded at once); the step losses as a device
        tensor."""
        table = self.opt.scalar_rows([self.opt.next_scalars(lr_at(self.opt.count)) for _ in range(n_steps)])
        losses = self.z.new_empty((n_steps,))
        for i in range(n_steps):
            self.opt.scalars.copy_(table[i])
            losses[i].copy_(self.step())
        return losses


class ZSearchCache:
    """The searches of one forward by LR / Z / mask shape and objective
    (``fn``, the names and shapes of its tensors, its other parameters), with
    one memory pool for their graphs. :meth:`clear` drops them (new generator
    weights: the graphs hold the old layouts' addresses)."""

    def __init__(self):
        self._searches: dict = {}

    def get(self, forward, lr_img, z, mask, fn, aux: dict) -> ZSearch:
        key = (id(forward), tuple(lr_img.shape), tuple(z.shape), tuple(mask.shape), fn,
               *((k, tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else (k, v)
                 for k, v in sorted(aux.items())))
        search = self._searches.get(key)
        if search is None:
            pool = next((s.step.pool for s in self._searches.values() if s.step.pool is not None), None)
            search = self._searches[key] = ZSearch(forward, lr_img, z, mask, fn, aux, pool)
        else:
            search.load(lr_img, z, mask, aux)
        return search

    def clear(self) -> None:
        self._searches.clear()


def optimize_z(forward, lr_img, z0, mask_hr, objective, n_steps: int = 100, lr: float = 0.1,
               z_range: float = 1.0, lr_decay: float = 1.0, progress_cb=None, n_chunks: int = 1,
               cache: ZSearchCache | None = None):
    """Search Z from ``z0`` for ``objective`` (an :class:`Objective` or a plain
    ``f(sr, mask)``) over ``n_steps`` Adam steps; ``lr_decay`` < 1 decays the
    LR exponentially to ``lr * lr_decay`` by the end. Returns (z, loss trace
    as a numpy array).

    ``progress_cb(done_steps, total_steps, losses_so_far)``: when given (or
    ``n_chunks`` > 1), the steps run in ``n_chunks`` chunks with Z and the
    Adam state carried across (the same steps), and the callback fires at
    each chunk's end. ``cache``: where the captured search is kept for the
    next call (a new one each call when None)."""
    fn, aux = _as_fn_aux(objective)
    search = (cache or ZSearchCache()).get(forward, lr_img, z0, mask_hr, fn, aux)
    search.set_round(z_range)
    lr_at = _decayed(lr, lr_decay, n_steps)
    n_chunks = 1 if progress_cb is None and n_chunks <= 1 else max(1, min(int(n_chunks), n_steps))
    bounds = np.linspace(0, n_steps, n_chunks + 1).astype(int)
    losses = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        losses.append(search.run(int(hi - lo), lr_at).cpu().numpy())
        if progress_cb is not None:
            progress_cb(int(hi), int(n_steps), np.concatenate(losses))
    return search.z.clone(), np.concatenate(losses) if losses else np.zeros((0,), np.float32)


def _ladder_rounds(cur: float, top: float, boost: float) -> int:
    """Rounds a ladder climbs from ``cur`` to ``top`` by ``boost``; none when
    there is nothing to climb or the boost is 1 or less."""
    if not (math.isfinite(cur) and math.isfinite(top)) or cur >= top or boost <= 1.0:
        return 0
    return max(0, math.ceil(math.log(top / cur) / math.log(boost) - 1e-9))


def optimize_z_adaptive(forward, lr_img, z0, mask_hr, objective, n_steps: int = 64, lr: float = 0.1,
                        z_range: float = 1.0, max_rounds: int | None = None, plateau_rel: float = 0.02,
                        lr_boost: float = 3.0, lr_max: float = 2.7, z_range_boost: float = 1.75,
                        z_range_max: float | None = None, progress_cb=None, cache: ZSearchCache | None = None):
    """Plateau-escalating Z search: rounds of ``n_steps`` with Z and the Adam
    state carried. After a round whose relative improvement ``(first - last)
    / |first|`` is below ``plateau_rel``, the Adam LR is boosted ``x
    lr_boost`` up to ``lr_max``; with the LR ladder done, the Z clip bound is
    widened ``x z_range_boost`` up to ``z_range_max``; a plateau at full
    escalation stops the search. Returns ``(z_best, losses, rounds)``: the
    best Z evaluated anywhere in the search, the loss trace, and per round
    ``{"lr", "z_range", "first", "last", "rel_improvement", "best"}`` (the last
    with ``"stop"``: why the search ended). ``cache`` as in :func:`optimize_z`."""
    fn, aux = _as_fn_aux(objective)
    search = (cache or ZSearchCache()).get(forward, lr_img, z0, mask_hr, fn, aux)
    # z_range 0 / None: unbounded (the round still clips, against inf)
    cur_lr = float(lr)
    cur_zr = float(z_range) if z_range else float("inf")
    zr_max = float(z_range_max) if z_range_max else cur_zr
    if max_rounds is None:
        # the initial round, the two ladders and one settle round at full escalation
        max_rounds = 1 + _ladder_rounds(cur_lr, lr_max, lr_boost) + _ladder_rounds(cur_zr, zr_max, z_range_boost) + 1
    best_z, best_loss = search.z.clone(), float("inf")
    all_losses, rounds = [], []
    total = max_rounds * n_steps
    stop_reason = None
    for r in range(max_rounds):
        search.set_round(cur_zr if math.isfinite(cur_zr) else None)
        round_lr = float(np.float32(cur_lr))
        losses = search.run(int(n_steps), lambda count: round_lr).cpu().numpy()
        all_losses.append(losses)
        rb_loss = float(search.best_loss)
        if rb_loss < best_loss:
            best_z, best_loss = search.best_z.clone(), rb_loss
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
        self.searches = ZSearchCache()  # captured by crop shape and objective

    def clear_searches(self) -> None:
        """Drop the captured searches (call after the forward's weights change)."""
        self.searches.clear()

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
                    z_range=self.z_range, z_range_max=z_range_max, progress_cb=progress_cb, cache=self.searches)
                self.last_rounds = rounds
                return z_o, losses
            return optimize_z(self.forward, lr_i, z_i, m_i, objective_i, n_steps=self.n_steps, lr=self.lr,
                              z_range=self.z_range, lr_decay=self.lr_decay, progress_cb=progress_cb,
                              n_chunks=n_chunks, cache=self.searches)

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
