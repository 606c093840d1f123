"""Serving artifacts (port of esr_tpu/export.py).

``export_servable(model, shapes, out_dir)`` writes a directory a server
loads with :func:`load_servable`, with no options JSON:

- ``manifest.json``: the JAX manifest's keys (scale, nz, in_nc, cem,
  self_ensemble, shape buckets, ...) plus ``"format": "esr_tpu_torch"``, the
  ``network_G`` block, ``bf16`` and the CEM's scale and kernel, which is
  everything needed to rebuild the model (a 2-D kernel, e.g. an estimated
  one, rebuilds CEM's fft mode, as the live model has it);
- ``G.pth``: the generator's state dict (reference ESRGAN keys).

Unlike the JAX package's StableHLO artifact, this one holds no compiled
program: loading it needs ``esr_tpu_torch``'s model code, and the kernels
are built (nvcc) at the first forward on CUDA. ``format_version`` is 2, so
that the JAX package's loader (version 1) refuses it ("newer than this
loader"), and :class:`Servable` refuses a JAX artifact by its missing
``format``.

:class:`Servable` keeps the JAX ``Servable.sr`` semantics: the smallest
bucket that fits, LR (and Z) edge-padded to it, the batch filled by
repeating the last image, zeros Z by default, SR cropped back. CEM
consistency therefore holds w.r.t. the padded LR, as in the eval loop.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.models.base_model import make_eval_forward
from esr_tpu_torch.models.networks import define_G

__all__ = ["MANIFEST_NAME", "Servable", "export_servable", "load_servable"]

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "G.pth"
FORMAT = "esr_tpu_torch"
EXPORT_FORMAT_VERSION = 2


def export_servable(model, shapes: list[tuple[int, int, int]], out_dir: str) -> dict:
    """Export ``model`` (an SRModel / SRRaGANModel of the port) for the LR
    shape buckets ``shapes`` ((batch, h, w) each). Returns the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    g = model.g_module
    torch.save({k: v.detach().cpu() for k, v in g.state_dict().items()},
               os.path.join(out_dir, WEIGHTS_NAME))
    cem = getattr(model, "cem", None)
    manifest = {
        "format": FORMAT,
        "format_version": EXPORT_FORMAT_VERSION,
        "scale": int(model.scale),
        "nz": int(model.nz),
        "in_nc": int(g.conv_first.weight.shape[1]) - int(model.nz),
        "platforms": ["cuda", "cpu"],
        "cem": cem is not None,
        "cem_scale": int(cem.scale) if cem is not None else None,
        "cem_kernel": (np.asarray(cem.conf.kernel).tolist()
                       if cem is not None and cem.conf.kernel is not None else None),
        "self_ensemble": bool(model.opt.get("self_ensemble")),
        "network_G": dict(model.opt["network_G"]),
        "bf16": g.dtype == torch.bfloat16,
        "buckets": [{"batch": int(b), "h": int(h), "w": int(w)} for b, h, w in shapes],
        "weights": WEIGHTS_NAME,
        "input": "NHWC RGB float32 in [0,1] (LR domain)",
        "output": "NHWC RGB float32 (CEM output is unbounded; clip for PNG)",
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_servable(art_dir: str, device: str | torch.device = "cuda") -> "Servable":
    """Load an artifact directory written by :func:`export_servable`."""
    return Servable(art_dir, device)


class Servable:
    """Callable serving wrapper over an :func:`export_servable` directory.

    ``sr(lr, z=None)`` takes an HWC image or NHWC batch (float [0,1]) and
    returns the SR batch (numpy f32) cropped back to ``input_shape * scale``
    (see module docstring)."""

    def __init__(self, art_dir: str, device: str | torch.device = "cuda"):
        self.dir = art_dir
        with open(os.path.join(art_dir, MANIFEST_NAME)) as f:
            m = json.load(f)
        if m.get("format") != FORMAT:
            raise ValueError(
                f"{art_dir} is not an esr_tpu_torch artifact (a JAX StableHLO artifact of "
                "esr_tpu.export?); load it with esr_tpu.export.load_servable, or re-export with "
                "python -m esr_tpu_torch.scripts.export_model")
        if m["format_version"] > EXPORT_FORMAT_VERSION:
            raise ValueError(f"artifact format {m['format_version']} is newer than this loader "
                             f"({EXPORT_FORMAT_VERSION})")
        self.manifest = m
        self.device = resolve_device(device)
        self.scale = int(m["scale"])
        self.nz = int(m["nz"])
        g = define_G({"network_G": m["network_G"], "scale": self.scale, "bf16": m["bf16"]},
                     device=self.device)
        g.load_state_dict(torch.load(os.path.join(art_dir, m["weights"]), map_location=self.device,
                                     weights_only=True), strict=True)
        cem = None
        if m["cem"]:
            kernel = m["cem_kernel"]
            kernel = None if kernel is None else (
                tuple(kernel) if np.ndim(kernel) == 1 else tuple(map(tuple, kernel)))
            cem = make_cem(CEMConf(scale=int(m["cem_scale"]), kernel=kernel), device=self.device)
        self.g = g
        self.cem = cem
        self.forward = make_eval_forward(g, cem, self_ensemble=bool(m["self_ensemble"]))

    @property
    def buckets(self) -> list[tuple[int, int, int]]:
        return [(e["batch"], e["h"], e["w"]) for e in self.manifest["buckets"]]

    def _bucket_for(self, n: int, h: int, w: int) -> tuple[int, int, int]:
        fits = [s for s in self.buckets if s[0] >= n and s[1] >= h and s[2] >= w]
        if not fits:
            raise ValueError(f"no exported bucket fits LR batch {(n, h, w)}; have {self.buckets} — "
                             "re-export with a larger bucket")
        return min(fits, key=lambda s: s[0] * s[1] * s[2])

    def sr(self, lr: np.ndarray, z: np.ndarray | None = None) -> np.ndarray:
        lr = np.asarray(lr, np.float32)
        if lr.ndim == 3:
            lr = lr[None]
        n, h, w, _ = lr.shape
        b, bh, bw = self._bucket_for(n, h, w)
        pad = ((0, 0), (0, bh - h), (0, bw - w), (0, 0))
        lr_p = np.pad(lr, pad, mode="edge")
        if b > n:  # repeat the last image to fill the bucket's batch
            lr_p = np.concatenate([lr_p, np.repeat(lr_p[-1:], b - n, axis=0)])
        z_p = None
        if self.nz:
            if z is None:
                z_p = np.zeros((b, bh, bw, self.nz), np.float32)
            else:
                z = np.asarray(z, np.float32)
                if z.ndim == 3:
                    z = z[None]
                z_p = np.pad(z, pad, mode="edge")
                if b > n:
                    z_p = np.concatenate([z_p, np.repeat(z_p[-1:], b - n, axis=0)])
            z_p = torch.from_numpy(z_p).to(self.device)
        elif z is not None:
            raise ValueError("this artifact was exported without latent channels")
        out = self.forward(torch.from_numpy(lr_p).to(self.device), z_p)
        s = self.scale
        return out[:n, : h * s, : w * s].cpu().numpy()
