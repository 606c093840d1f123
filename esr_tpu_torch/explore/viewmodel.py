"""Editor view-model (port of esr_tpu/explore/viewmodel.py): the
explorable-SR editor as a headless state machine.

Load LR, run the explorable model, select regions (rectangle / polygon /
brush), apply Z-optimization tools (imprint text or image, variance up /
down, brightness, periodicity, smoothing, histogram transfer, realism,
random diverse alternatives with a choose-one-of-k picker), inspect the Z
map, undo / redo, save / load sessions. ``esr_tpu_torch.explore.gui`` is
widget wiring over this class; the terminal CLI shares it too.

Event protocol (what a GUI front-end forwards): ``pointer_down/drag/up(y,
x)`` in HR-display coordinates, read per ``selection_mode`` ('rect' drag,
'polygon' click-to-add + finish_polygon(), 'brush' paint with
brush_radius). Tool methods return human-readable status strings;
``on_progress(done, total, losses)`` fires during searches (the chunked
search of ``z_optimizer.optimize_z``).

One deliberate divergence: :func:`render_text_mask` draws with a built-in 5 x
7 bitmap font (the card's machine has no PIL), so its glyphs differ from
PIL's default font; the contract is the same.
"""

from __future__ import annotations

import numpy as np

from esr_tpu_torch.ops.color import tensor2img

__all__ = ["EditorViewModel", "render_text_mask"]

_MODES = ("rect", "polygon", "brush")

# 5 x 7 glyphs of printable ASCII (32 ' ' .. 126 '~'): 5 columns each, bit r
# of a column byte is row r (top row = bit 0).
_FONT_HEX = (
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462" "3649552250"
    "0005030000" "001c224100" "0041221c00" "082a1c2a08" "08083e0808" "0050300000" "0808080808"
    "0060600000" "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31" "1814127f10"
    "2745454539" "3c4a494930" "0171090503" "3649494936" "064949291e" "0036360000" "0056360000"
    "0008142241" "1414141414" "4122140800" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906"
    "3e4151215e" "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f" "7f2018207f"
    "6314081463" "0304780403" "6151494543" "00007f4141" "0204081020" "41417f0000" "0402010204"
    "4040404040" "0001020400" "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "081454543c" "7f08040478" "00447d4000" "2040443d00" "007f102844" "00417f4000"
    "7c04180478" "7c08040478" "3844444438" "7c14141408" "081414187c" "7c08040408" "4854545420"
    "043f444020" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c" "4464544c44"
    "0008364100" "00007f0000" "0041360800" "08082a1c08"
)
_GLYPHS = np.array(
    [[[(int(_FONT_HEX[10 * c + 2 * col: 10 * c + 2 * col + 2], 16) >> row) & 1 for col in range(5)]
      for row in range(7)] for c in range(95)], np.float32)  # (95, 7, 5)


def _text_bitmap(text: str) -> np.ndarray:
    """``text`` in the 5 x 7 font, one blank column between glyphs; a
    character outside printable ASCII draws as '?'."""
    cols = []
    for i, ch in enumerate(text):
        code = ord(ch) - 32 if 32 <= ord(ch) < 127 else ord("?") - 32
        if i:
            cols.append(np.zeros((7, 1), np.float32))
        cols.append(_GLYPHS[code])
    return np.concatenate(cols, axis=1) if cols else np.zeros((7, 0), np.float32)


def _area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) area-average resampling: output pixel o covers input
    span [o, o + 1) * n_in / n_out and takes the mean over it."""
    step = n_in / n_out
    lo = np.arange(n_out)[:, None] * step
    i = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(lo + step, i + 1) - np.maximum(lo, i), 0.0, None)
    return overlap / step


def render_text_mask(text: str, box_hw: tuple[int, int], size: int | None = None) -> np.ndarray:
    """Rasterize ``text`` into a float [0, 1] alpha mask of shape ``box_hw``,
    shrinking the glyphs until the text fits, centred (the reference GUI's
    imprint-text / graffiti entry). ``size``: the largest glyph height in
    pixels (default 0.8 of the box's height, at least 6)."""
    h, w = int(box_hw[0]), int(box_hw[1])
    if h <= 0 or w <= 0:
        raise ValueError(f"empty text box {box_hw}")
    bitmap = _text_bitmap(text)
    out = np.zeros((h, w), np.float32)
    if bitmap.shape[1] == 0:
        return out
    size = int(size) if size else max(6, int(h * 0.8))
    scale = min(size / 7.0, h / 7.0, w / bitmap.shape[1])
    th = min(h, max(1, round(7 * scale)))
    tw = min(w, max(1, round(bitmap.shape[1] * scale)))
    glyphs = _area_matrix(7, th) @ bitmap @ _area_matrix(bitmap.shape[1], tw).T
    y0, x0 = (h - th) // 2, (w - tw) // 2
    out[y0 : y0 + th, x0 : x0 + tw] = np.clip(glyphs, 0.0, 1.0)
    return out


def _paint_disk(mask: np.ndarray, y: int, x: int, radius: int) -> None:
    h, w = mask.shape
    y0, y1 = max(0, y - radius), min(h, y + radius + 1)
    x0, x1 = max(0, x - radius), min(w, x + radius + 1)
    if y0 >= y1 or x0 >= x1:
        return
    ys, xs = np.ogrid[y0:y1, x0:x1]
    mask[y0:y1, x0:x1][(ys - y) ** 2 + (xs - x) ** 2 <= radius**2] = 1.0


def _mask_boundary(mask: np.ndarray) -> np.ndarray:
    """1px-wide boundary of a binary mask (in-mask pixels with an out-of-mask
    4-neighbor), for the selection outline overlay."""
    m = mask > 0
    interior = m.copy()
    interior[1:] &= m[:-1]
    interior[:-1] &= m[1:]
    interior[:, 1:] &= m[:, :-1]
    interior[:, :-1] &= m[:, 1:]
    return m & ~interior


class EditorViewModel:
    """Headless editor over an :class:`~esr_tpu_torch.explore.session.ExplorationSession`."""

    def __init__(self, session, brush_radius: int = 8):
        self.session = session
        self.selection_mode = "rect"
        self.brush_radius = int(brush_radius)
        self.show_zmap = False
        self.candidates: list[tuple[np.ndarray, np.ndarray]] = []
        self.status = "ready"
        self.last_progress: tuple[int, int] | None = None
        # GUI hooks (optional): on_progress(done, total, losses), on_status(str)
        self._on_progress = None
        self.on_status = None
        self._drag_start: tuple[int, int] | None = None
        self._drag_cur: tuple[int, int] | None = None  # live rubber-band corner
        self._poly_vertices: list[tuple[int, int]] = []
        self._brush_mask: np.ndarray | None = None

    # -- status / progress plumbing ----------------------------------------

    @property
    def on_progress(self):
        return self._on_progress

    @on_progress.setter
    def on_progress(self, cb) -> None:
        """Attaching a listener switches tool searches to the chunked search
        (the loss trace is fetched at each chunk's end); without one it is
        fetched once per search."""
        self._on_progress = cb
        self.session.progress_cb = self._emit_progress if cb is not None else None

    def _set_status(self, msg: str) -> str:
        self.status = msg
        if self.on_status is not None:
            self.on_status(msg)
        return msg

    def _emit_progress(self, done: int, total: int, losses) -> None:
        self.last_progress = (int(done), int(total))
        if self.on_progress is not None:
            self.on_progress(int(done), int(total), losses)

    # -- selection: pointer-event protocol ----------------------------------

    def set_selection_mode(self, mode: str) -> str:
        if mode not in _MODES:
            raise ValueError(f"selection mode must be one of {_MODES}, got {mode!r}")
        self.selection_mode = mode
        self._drag_start = None
        self._drag_cur = None
        self._poly_vertices = []
        self._brush_mask = None
        return self._set_status(f"selection mode: {mode}")

    def _clip(self, y: int, x: int) -> tuple[int, int]:
        h, w = self.session.hr_shape
        return min(max(int(y), 0), h - 1), min(max(int(x), 0), w - 1)

    def pointer_down(self, y: int, x: int) -> None:
        y, x = self._clip(y, x)
        if self.selection_mode == "rect":
            self._drag_start = (y, x)
        elif self.selection_mode == "polygon":
            self._poly_vertices.append((y, x))
            self._set_status(f"polygon: {len(self._poly_vertices)} vertices")
        else:  # brush
            if self._brush_mask is None:
                self._brush_mask = np.zeros(self.session.hr_shape, np.float32)
            _paint_disk(self._brush_mask, y, x, self.brush_radius)

    def pointer_drag(self, y: int, x: int) -> None:
        y, x = self._clip(y, x)
        if self.selection_mode == "brush" and self._brush_mask is not None:
            _paint_disk(self._brush_mask, y, x, self.brush_radius)
        elif self.selection_mode == "rect" and self._drag_start is not None:
            self._drag_cur = (y, x)

    def pointer_up(self, y: int, x: int) -> None:
        y, x = self._clip(y, x)
        if self.selection_mode == "rect" and self._drag_start is not None:
            y0, x0 = self._drag_start
            self._drag_start = None
            self._drag_cur = None
            self.session.select_rect(min(y0, y), min(x0, x), max(y0, y) + 1, max(x0, x) + 1)
            self._set_status(f"selected rect ({min(y0, y)},{min(x0, x)})-({max(y0, y)},{max(x0, x)})")
        elif self.selection_mode == "brush" and self._brush_mask is not None:
            _paint_disk(self._brush_mask, y, x, self.brush_radius)
            self.session.select_mask(self._brush_mask)
            self._set_status(f"brush selection: {int((self._brush_mask > 0).sum())} px")

    def finish_polygon(self) -> str:
        if len(self._poly_vertices) < 3:
            return self._set_status("polygon needs at least 3 vertices")
        self.session.select_polygon(self._poly_vertices)
        n = len(self._poly_vertices)
        self._poly_vertices = []
        return self._set_status(f"selected polygon ({n} vertices)")

    def clear_selection(self) -> str:
        self.session._mask = None
        self.session._box_lr = None
        self._poly_vertices = []
        self._brush_mask = None
        return self._set_status("selection cleared")

    @property
    def selection_mask(self) -> np.ndarray | None:
        return self.session._mask

    # -- rendering -----------------------------------------------------------

    def zmap_image(self) -> np.ndarray:
        """Visualize the Z map as a signed blue-white-red uint8 image at HR
        resolution (nearest upscale); channels tiled horizontally."""
        z = self.session.z[0]  # (h, w, nz)
        s = self.session.scale
        v = np.clip(z, -1.0, 1.0)
        v = np.repeat(np.repeat(v, s, axis=0), s, axis=1)
        panels = []
        for c in range(v.shape[-1]):
            x = v[..., c]
            rgb = np.ones(x.shape + (3,), np.float32)
            rgb[..., 1] -= np.abs(x)  # white -> red (x>0) / blue (x<0)
            rgb[..., 2] -= np.maximum(x, 0)
            rgb[..., 0] -= np.maximum(-x, 0)
            panels.append(rgb)
        return (np.concatenate(panels, axis=1) * 255).round().astype(np.uint8)

    def render_display(
        self, show_selection: bool = True, zmap_alpha: float = 0.5
    ) -> np.ndarray:
        """The editor canvas: current SR as uint8, optionally blended with the
        Z-map view (first channel) and overlaid with the selection outline."""
        img = tensor2img(self.session.current_sr()[0]).astype(np.float32)
        if self.show_zmap:
            h, w = self.session.hr_shape
            zimg = self.zmap_image()[:, :w].astype(np.float32)
            img = (1 - zmap_alpha) * img + zmap_alpha * zimg
        mask = self._brush_mask if self._brush_mask is not None else self.session._mask
        if show_selection and mask is not None:
            edge = _mask_boundary(mask)
            img[edge] = (255.0, 255.0, 0.0)  # yellow outline
        if show_selection and self._drag_start is not None and self._drag_cur is not None:
            # live rubber band for an in-progress rect drag (SR itself is
            # cached by the session, so this refresh is host-side only)
            (ya, xa), (yb, xb) = self._drag_start, self._drag_cur
            y0, y1 = sorted((ya, yb))
            x0, x1 = sorted((xa, xb))
            img[y0 : y1 + 1, (x0, x1)] = (255.0, 255.0, 0.0)
            img[(y0, y1), x0 : x1 + 1] = (255.0, 255.0, 0.0)
        return img.round().clip(0, 255).astype(np.uint8)

    # -- tools ---------------------------------------------------------------

    def set_search_steps(self, n_steps: int) -> str:
        if n_steps < 1:
            raise ValueError("steps must be >= 1")
        self.session.set_search_strength(n_steps=n_steps)
        return self._set_status(f"search steps set to {n_steps}")

    def set_z_range_max(self, z_range_max: float) -> str:
        self.session.set_search_strength(z_range_max=z_range_max)
        cur = self.session.z_range_max
        return self._set_status(
            f"adaptive z-range ceiling set to {cur:g}" if cur
            else "adaptive z-range widening disabled (edits stay in the trained box)"
        )

    def variance(self, direction: int) -> str:
        losses = (
            self.session.increase_variance()
            if direction > 0
            else self.session.decrease_variance()
        )
        return self._set_status(
            f"variance {'+' if direction > 0 else '-'}: loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        )

    def brightness(self, level: float) -> str:
        losses = self.session.brightness(float(level))
        return self._set_status(f"brightness {level:g}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    def smooth(self) -> str:
        losses = self.session.smooth()
        return self._set_status(f"smooth: loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    def periodicity(self, period_y: float = 0.0, period_x: float = 0.0) -> str:
        losses = self.session.periodicity(period_y, period_x)
        return self._set_status(f"periodicity: loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    def match_histogram(self, target_patch: np.ndarray) -> str:
        losses = self.session.match_histogram(np.asarray(target_patch, np.float32))
        return self._set_status(
            f"histogram: loss {losses[0]:.4f} -> {self._final_loss(losses):.4f}"
            f"{self._rounds_suffix()}"
        )

    def _rounds_suffix(self) -> str:
        """Adaptive-search escalation report for the status line: which LR
        levels ran and where the search stopped."""
        rounds = self.session.last_rounds
        if not rounds:
            return ""
        lrs = "->".join(f"{r['lr']:g}" for r in rounds)
        tail = rounds[-1]
        widened = ""
        if tail.get("z_range", 0) > rounds[0].get("z_range", 0):
            # the measured converged-region lever: say loudly that the edit
            # left the trained latent box (still exactly CEM-consistent)
            widened = (
                f", z-range widened to {tail['z_range']:g} "
                "(outside the trained latent box; output stays CEM-consistent)"
            )
        stopped = {
            "insensitive-at-max-escalation": " (insensitive at max escalation)",
            "plateaued-at-round-budget": " (plateaued; round budget exhausted)",
        }.get(tail.get("stop"), "")
        return f" [adaptive: {len(rounds)} rounds, lr {lrs}{widened}{stopped}]"

    def _final_loss(self, losses) -> float:
        """Adaptive searches return the BEST evaluated Z (z_optimizer
        docstring) — report that loss, not the trace's (possibly
        overshooting) endpoint."""
        rounds = self.session.last_rounds
        return float(rounds[-1]["best"]) if rounds else float(losses[-1])

    def realism(self, direction: int) -> str:
        """The adversarial exploration tool: push the
        discriminator's realism score on the region up (+) or down (-).
        Requires ``session.set_discriminator(...)`` first."""
        losses = self.session.realism(+1.0 if direction > 0 else -1.0)
        return self._set_status(
            f"realism {'+' if direction > 0 else '-'}: "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(D score {self.session.d_score():+.3f})"
        )

    def imprint_image(self, target_hr: np.ndarray) -> str:
        """Imprint a desired HR image over the selected region. Accepts a
        full-HR-size image or a patch sized to the selection's bbox."""
        target_hr = np.asarray(target_hr, np.float32)
        h, w = self.session.hr_shape
        if target_hr.shape[:2] != (h, w):
            box = self._selection_bbox()
            y0, x0, y1, x1 = box
            if target_hr.shape[:2] != (y1 - y0, x1 - x0):
                from esr_tpu_torch.ops.resize import imresize_np

                target_hr = imresize_np(target_hr, out_shape=(y1 - y0, x1 - x0))
            full = self.session.current_sr()[0].copy()
            full[y0:y1, x0:x1] = target_hr
            target_hr = full
        losses = self.session.imprint(target_hr)
        return self._set_status(
            f"imprint: loss {losses[0]:.4f} -> {self._final_loss(losses):.4f}"
            f"{self._rounds_suffix()}"
        )

    def imprint_text(
        self, text: str, color=(1.0, 1.0, 1.0), font_size: int | None = None
    ) -> str:
        """Imprint rendered text ('graffiti') into the selected region: the
        text alpha is composited over the current SR inside the selection
        bbox, then L1-imprinted. The result stays exactly CEM-consistent."""
        y0, x0, y1, x1 = self._selection_bbox()
        alpha = render_text_mask(text, (y1 - y0, x1 - x0), size=font_size)[..., None]
        target = self.session.current_sr()[0].copy()
        patch = target[y0:y1, x0:x1]
        target[y0:y1, x0:x1] = patch * (1 - alpha) + np.asarray(color, np.float32) * alpha
        losses = self.session.imprint(target)
        return self._set_status(
            f"imprint '{text}': loss {losses[0]:.4f} -> {self._final_loss(losses):.4f}"
            f"{self._rounds_suffix()}"
        )

    def _selection_bbox(self) -> tuple[int, int, int, int]:
        mask = self.session._mask
        if mask is None:
            h, w = self.session.hr_shape
            return 0, 0, h, w
        ys, xs = np.nonzero(mask > 0)
        if not len(ys):
            raise ValueError("empty selection")
        return int(ys.min()), int(xs.min()), int(ys.max()) + 1, int(xs.max()) + 1

    # -- alternatives picker (choose-one-of-k) -------------------------------

    def generate_alternatives(self, k: int = 3, seed: int = 0) -> str:
        """Propose k diverse consistent candidates for the region (nothing is
        committed); thumbnails via candidate_image(i); commit with
        pick_alternative(i) or discard with cancel_alternatives()."""
        def cb(i, n):
            self._emit_progress(i, n, None)

        self.candidates = self.session.propose_alternatives(k, seed=seed, candidate_cb=cb)
        return self._set_status(f"{len(self.candidates)} alternatives ready — pick one")

    def candidate_image(self, i: int) -> np.ndarray:
        return tensor2img(self.candidates[i][1][0])

    def pick_alternative(self, i: int) -> str:
        if not (0 <= i < len(self.candidates)):
            raise IndexError(f"no candidate {i} (have {len(self.candidates)})")
        self.session.apply_alternative(self.candidates[i][0])
        self.candidates = []
        return self._set_status(f"applied alternative {i}")

    def cancel_alternatives(self) -> str:
        self.candidates = []
        return self._set_status("alternatives discarded")

    # -- history / io ---------------------------------------------------------

    def undo(self) -> str:
        self.session.undo()
        return self._set_status("undone")

    def redo(self) -> str:
        self.session.redo()
        return self._set_status("redone")

    def reset_region(self) -> str:
        self.session.reset_region_z()
        return self._set_status("region Z reset")

    def save_image(self, path: str) -> str:
        self.session.save_sr(path)
        return self._set_status(f"saved {path}")

    def save_session(self, path: str) -> str:
        self.session.save_state(path)
        return self._set_status(f"session saved to {path}")

    def load_session(self, path: str) -> str:
        self.session.load_state(path)
        self.candidates = []
        self._poly_vertices = []
        self._brush_mask = None
        return self._set_status(f"session loaded from {path}")
