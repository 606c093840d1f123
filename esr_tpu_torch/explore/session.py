"""Headless exploration session (port of esr_tpu/explore/session.py).

The editing model of the explorable-SR editor: load LR -> SR with Z = 0;
select a region (rectangle, polygon, brush mask); apply tools (imprint,
variance up / down, brightness, periodicity, TV smoothing, histogram match,
realism, random diverse alternatives); per-region Z with undo / redo; save
the SR and the session.

The forward of every tool is ``cem.project(g(lr, z), lr)`` with ``g``
frozen: its parameters need no gradient and its kernels' weight layouts are
built once (``prepare_kernels``), so each Z step runs the kernels forward on
them and the plain recompute backward differentiates only Z
(``ops/cuda/autograd.py``). The SR render (the whole image, no gradient) is
a callable of its own, ``make_eval_forward``'s, a CUDA graph per image shape
on the card; the Z search calls :meth:`ExplorationSession.forward` inside its
own graph's capture, and captures do not nest.
:meth:`ExplorationSession.set_generator_weights` loads new weights and
rebuilds the layouts. Z and the LR image are kept on
the host as numpy, as in the JAX package, and go to the device once per tool
click.

One deliberate divergence: the reference's ``match_histogram`` ignores the
session's ``zmax`` (it never widens the Z box); here it takes the session's
ceiling, as ``imprint`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from esr_tpu_torch.explore import objectives as obj
from esr_tpu_torch.explore.z_optimizer import ZOptimizer, bucket_crop
from esr_tpu_torch.models.base_model import make_eval_forward
from esr_tpu_torch.models.networks import normalize_rrdb_keys

__all__ = ["ExplorationSession"]


class ExplorationSession:
    def __init__(self, g, cem, lr_img: np.ndarray, num_latent_channels: int = 1, scale: int = 4,
                 n_steps: int = 64, opt_lr: float = 0.1, history_limit: int = 32, progress_cb=None,
                 progress_chunks: int = 8, anchor_cap: int = 8):
        """``g``: the generator (an ``RRDBNet``), frozen here; ``cem``: its CEM
        projection or None; ``lr_img`` (H, W, 3) or (N, H, W, 3) in [0, 1]. The
        session runs on ``g``'s device."""
        if lr_img.ndim == 3:
            lr_img = lr_img[None]
        self.lr_img = np.asarray(lr_img, np.float32)
        self.scale = scale
        self.nz = num_latent_channels
        n, h, w, _ = self.lr_img.shape
        self.z = np.zeros((n, h, w, num_latent_channels), np.float32)
        self.g, self.cem = g, cem
        self.device = next(g.parameters()).device
        g.requires_grad_(False)
        self._render = make_eval_forward(g, cem)  # builds the kernels' layouts
        self._optimizer = ZOptimizer(self.forward, scale=scale, n_steps=n_steps, lr=opt_lr, device=self.device)
        self._history: list[np.ndarray] = []
        self._redo: list[np.ndarray] = []
        self._history_limit = history_limit
        # progress_cb(done_steps, total_steps, losses_so_far): when set, tool
        # searches run chunked (the same steps) so a GUI can show progress
        self.progress_cb = progress_cb
        self.progress_chunks = progress_chunks
        self.anchor_cap = anchor_cap  # padded-anchor capacity (propose_alternatives)
        self.z_range_max = 3.0  # the adaptive tools' escalation ceiling
        self._mask: np.ndarray | None = None  # HR-space float mask
        self._box_lr: tuple | None = None
        self._sr_cache: np.ndarray | None = None
        self._d = None  # the discriminator of the realism tool

    # -- the generator -------------------------------------------------------

    def forward(self, lr: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """``cem.project(g(lr, z), lr)`` (raw ``g`` without a CEM)."""
        raw = self.g(lr, z)
        return self.cem.project(raw, lr) if self.cem is not None else raw

    def set_generator_weights(self, state_dict: dict) -> None:
        """Load new generator weights (strictly; either reference key layout,
        ``normalize_rrdb_keys``) and rebuild the kernels' layouts from them;
        the cached SR, the render's graphs and the captured Z searches are
        dropped."""
        self.g.load_state_dict(normalize_rrdb_keys(state_dict), strict=True)
        self.g.requires_grad_(False)
        self.g.release_kernels()
        self.g.prepare_kernels()
        self._render.graphs.clear()
        self._optimizer.clear_searches()
        self._sr_cache = None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    # -- region selection --------------------------------------------------

    @property
    def hr_shape(self):
        n, h, w, _ = self.lr_img.shape
        return (h * self.scale, w * self.scale)

    def select_rect(self, y0: int, x0: int, y1: int, x1: int) -> None:
        """Rectangle in HR coordinates."""
        mask = np.zeros(self.hr_shape, np.float32)
        mask[y0:y1, x0:x1] = 1.0
        self._set_mask(mask)

    def select_polygon(self, vertices) -> None:
        """Polygon (list of (y, x) HR coords), even-odd rasterization."""
        h, w = self.hr_shape
        ys, xs = np.mgrid[0:h, 0:w]
        v = np.asarray(vertices, np.float32)
        n = len(v)
        inside = np.zeros((h, w), bool)
        j = n - 1
        for i in range(n):
            yi, xi = v[i]
            yj, xj = v[j]
            cond = ((v[i, 0] > ys) != (v[j, 0] > ys)) & (xs < (xj - xi) * (ys - yi) / (yj - yi + 1e-12) + xi)
            inside ^= cond
            j = i
        self._set_mask(inside.astype(np.float32))

    def select_mask(self, mask_hr: np.ndarray) -> None:
        """Arbitrary brush mask (float or bool, HR-space)."""
        self._set_mask(np.asarray(mask_hr, np.float32))

    def _set_mask(self, mask: np.ndarray) -> None:
        if mask.shape != self.hr_shape:
            raise ValueError(f"mask shape {mask.shape} != HR shape {self.hr_shape}")
        self._mask = mask
        ys, xs = np.nonzero(mask > 0)
        if len(ys):
            s = self.scale
            self._box_lr = (int(ys.min()) // s, int(xs.min()) // s,
                            -(-int(ys.max() + 1) // s), -(-int(xs.max() + 1) // s))
        else:
            self._box_lr = None

    # -- core ops ----------------------------------------------------------

    def _sr(self, z: np.ndarray) -> np.ndarray:
        return self._render(self._tensor(self.lr_img), self._tensor(z)).float().cpu().numpy()

    def current_sr(self, z: np.ndarray | None = None) -> np.ndarray:
        """The SR of the session's Z (cached until Z changes), or of ``z``."""
        if z is None:
            if self._sr_cache is None:
                self._sr_cache = self._sr(self.z)
            return self._sr_cache
        return self._sr(z)

    def _push_history(self) -> None:
        self._history.append(self.z.copy())
        if len(self._history) > self._history_limit:
            self._history.pop(0)
        self._redo.clear()

    def undo(self) -> None:
        if self._history:
            self._redo.append(self.z.copy())
            self.z = self._history.pop()
            self._sr_cache = None

    def redo(self) -> None:
        if self._redo:
            self._history.append(self.z.copy())
            self.z = self._redo.pop()
            self._sr_cache = None

    def reset_region_z(self) -> None:
        """Zero the Z map inside the selected region."""
        self._push_history()
        self.z = self.z * (1.0 - self._mask_lr()[None, :, :, None])
        self._sr_cache = None

    def _mask_lr(self) -> np.ndarray:
        s = self.scale
        m = self._mask if self._mask is not None else np.ones(self.hr_shape, np.float32)
        h, w = m.shape
        return m.reshape(h // s, s, w // s, s).max(axis=(1, 3))

    def _run_tool(self, objective, adaptive: bool = False, z_range_max: float | None = None) -> np.ndarray:
        if self._mask is None:
            self._mask = np.ones(self.hr_shape, np.float32)
        self._push_history()
        z_opt, losses = self._optimizer(
            self.lr_img, self.z, objective, mask_hr=self._mask, box_lr=self._box_lr,
            progress_cb=self.progress_cb, n_chunks=self.progress_chunks if self.progress_cb else 1,
            adaptive=adaptive, z_range_max=z_range_max,
        )
        self.z = z_opt.cpu().numpy()
        self._sr_cache = None
        return np.asarray(losses)

    @property
    def last_rounds(self):
        """Escalation report of the last adaptive tool run, or None."""
        return self._optimizer.last_rounds

    # -- tools ---------------------------------------------------------------

    def set_search_strength(self, n_steps: int | None = None, z_range_max: float | None = None) -> None:
        """Editor-level search controls: ``n_steps`` per search round;
        ``z_range_max`` caps the adaptive tools' Z-box widening (0 disables it)."""
        if n_steps is not None:
            self._optimizer.n_steps = int(n_steps)
        if z_range_max is not None:
            self.z_range_max = float(z_range_max) or None

    def _zmax(self, z_range_max):
        return self.z_range_max if z_range_max == "session" else z_range_max

    def imprint(self, target_hr: np.ndarray, adaptive: bool = True,
                z_range_max: float | None | str = "session") -> np.ndarray:
        """Imprint desired content (rendered text, an image) in the region.
        Adaptive by default: the LR, then (``z_range_max``, by default the
        session's ceiling) the Z box are widened on plateaus; the output stays
        exactly CEM-consistent. ``last_rounds`` reports the escalation."""
        return self._run_tool(obj.imprint_objective(np.asarray(target_hr, np.float32)), adaptive=adaptive,
                              z_range_max=self._zmax(z_range_max))

    def increase_variance(self) -> np.ndarray:
        return self._run_tool(obj.variance_objective(+1.0))

    def decrease_variance(self) -> np.ndarray:
        return self._run_tool(obj.variance_objective(-1.0))

    def brightness(self, target_level: float) -> np.ndarray:
        return self._run_tool(obj.brightness_objective(float(target_level)))

    def smooth(self) -> np.ndarray:
        return self._run_tool(obj.tv_objective())

    def periodicity(self, period_y: float = 0.0, period_x: float = 0.0) -> np.ndarray:
        return self._run_tool(obj.periodicity_objective(period_y, period_x))

    def match_histogram(self, target_patch: np.ndarray, adaptive: bool = True,
                        z_range_max: float | None | str = "session") -> np.ndarray:
        """Transfer a target patch's intensity distribution to the region,
        adaptive like :meth:`imprint` and with its Z-box ceiling (the
        reference leaves this tool inside the trained box whatever ``zmax``
        says)."""
        return self._run_tool(obj.histogram_objective(np.asarray(target_patch, np.float32)), adaptive=adaptive,
                              z_range_max=self._zmax(z_range_max))

    def set_discriminator(self, d_module) -> None:
        """Attach a discriminator (a ``DiscriminatorVGG128`` with trained
        weights), frozen, for the realism tool and ``d_score``."""
        self._d = d_module.requires_grad_(False)

    def realism(self, direction: float = 1.0) -> np.ndarray:
        """Push the region's D realism score up (direction > 0) or down."""
        if self._d is None:
            raise ValueError(
                "no discriminator attached — call set_discriminator() (e.g. with the experiment's "
                "latest_D.pth / path.pretrain_model_D) before using the realism tool")
        return self._run_tool(obj.adversarial_objective(self._d, float(direction)))

    @torch.no_grad()
    def d_score(self) -> float:
        """Mean D logit of the current SR in the selection, cropped to the
        selection's bucketed box as the realism tool's search sees it."""
        if self._d is None:
            raise ValueError("no discriminator attached — call set_discriminator()")
        objective = obj.adversarial_objective(self._d, -1.0)  # -1: the objective is +mean(logits)
        mask = self._mask if self._mask is not None else np.ones(self.hr_shape, np.float32)
        sr, m = self.current_sr(), mask
        if self._box_lr is not None:
            h, w = self.lr_img.shape[1:3]
            y, x, size = bucket_crop(self._box_lr, h, w, self.scale)
            s = self.scale
            sr = sr[:, y * s : (y + size) * s, x * s : (x + size) * s]
            m = m[y * s : (y + size) * s, x * s : (x + size) * s]
        return float(objective.fn(self._tensor(sr), self._tensor(m), objective.aux))

    def propose_alternatives(self, k: int = 3, seed: int = 0, candidate_cb=None) -> list[tuple[np.ndarray, np.ndarray]]:
        """k diverse consistent candidates for the region, none committed:
        random Z restarts in the region (``np.random.default_rng(seed)``, the
        JAX package's draws), each repelled from the SRs before it, the anchor
        stack padded to a fixed capacity with zero-weight rows. Returns
        ``[(z_full, sr), ...]``; :meth:`apply_alternative` commits one."""
        if self._mask is None:
            self._mask = np.ones(self.hr_shape, np.float32)
        cands: list[tuple[np.ndarray, np.ndarray]] = []
        rng = np.random.default_rng(seed)
        mask_lr = self._mask_lr()[None, :, :, None]
        base_z = self.z.copy()
        anchors = [self.current_sr()]
        cap = max(self.anchor_cap, k)
        hh, ww, cc = anchors[0].shape[1:]
        for i in range(k):
            z_init = base_z * (1 - mask_lr) + mask_lr * rng.uniform(-1, 1, self.z.shape).astype(np.float32)
            padded = np.zeros((cap, hh, ww, cc), np.float32)
            padded[: len(anchors)] = np.stack(anchors)[:, 0]
            weights = np.zeros((cap,), np.float32)
            weights[: len(anchors)] = 1.0
            z_opt, _ = self._optimizer(self.lr_img, z_init,
                                       obj.random_diverse_objective(padded, anchor_weights=weights),
                                       mask_hr=self._mask, box_lr=self._box_lr)
            z_opt = z_opt.cpu().numpy()
            sr = self._sr(z_opt)
            anchors.append(sr)
            cands.append((z_opt, sr))
            if candidate_cb is not None:
                candidate_cb(i + 1, k)
        return cands

    def apply_alternative(self, z: np.ndarray) -> None:
        """Commit a candidate Z map (one undo step, like any other tool)."""
        if z.shape != self.z.shape:
            raise ValueError(f"candidate z shape {z.shape} != {self.z.shape}")
        self._push_history()
        self.z = np.asarray(z, np.float32).copy()
        self._sr_cache = None

    def random_alternatives(self, k: int = 3, seed: int = 0) -> list[np.ndarray]:
        """k alternatives, each committed in turn (undo steps back through them)."""
        cands = self.propose_alternatives(k, seed)
        for z_opt, _ in cands:
            self.apply_alternative(z_opt)
        return [sr for _, sr in cands]

    # -- io ---------------------------------------------------------------

    def save_sr(self, path: str) -> None:
        from esr_tpu_torch.data.util import save_img
        from esr_tpu_torch.ops.color import tensor2img

        save_img(tensor2img(self.current_sr()[0]), path)

    def save_state(self, path: str) -> None:
        """Persist the editing state (LR, Z map, selection) as an npz."""
        state = {"z": self.z, "lr": self.lr_img}
        if self._mask is not None:
            state["mask"] = self._mask
        np.savez(path, **state)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        self.z = data["z"]
        self.lr_img = data["lr"]
        if "mask" in data:
            self._set_mask(data["mask"])
        else:
            self._mask = None
            self._box_lr = None
        self._history.clear()
        self._redo.clear()
        self._sr_cache = None
