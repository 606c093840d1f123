"""Geometric x8 self-ensemble for eval (port of esr_tpu/ops/ensemble.py).

Average the eight dihedral-transformed forwards ``inv_t(G(t(LR), t(Z)))``
as TWO batched calls: the four shape-preserving flips {I, H, V, HV}
together, then the four transposed variants {T, T.H, T.V, T.HV} together
(each group is shape-homogeneous, so rectangular images work). The wrapper
sits on the RAW generator; the caller projects the MEAN through CEM once:
the constraint set {x : H(x) = LR} is affine, so the projected mean is
exactly consistent. Z rides the same transform as the image.

Codes follow the JAX package's ``data/pipeline.py::dihedral_transform``
numbering (0..7).
"""

from __future__ import annotations

import torch

__all__ = ["INVERSE_CODE", "apply_code", "make_self_ensemble"]

# inverse of each dihedral code: T.H and T.V are each other's inverses; the
# rest are involutions
INVERSE_CODE = (0, 1, 2, 3, 4, 6, 5, 7)


def apply_code(x: torch.Tensor, code: int) -> torch.Tensor:
    """Apply dihedral ``code`` to an NHWC batch."""
    if not 0 <= code <= 7:
        raise ValueError(f"dihedral code must be 0..7, got {code}")
    if code >= 4:
        x = x.transpose(1, 2)
    if code % 4 in (2, 3):
        x = x.flip(1)
    if code % 4 in (1, 3):
        x = x.flip(2)
    return x


def make_self_ensemble(apply_raw):
    """Wrap a raw forward ``f(lr, z) -> sr`` into its x8 dihedral ensemble
    (two batched calls, see module docstring)."""

    def fwd(lr: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        n = lr.shape[0]
        out = None
        for group in ((0, 1, 2, 3), (4, 5, 6, 7)):
            lrt = torch.cat([apply_code(lr, c) for c in group])
            zt = torch.cat([apply_code(z, c) for c in group]) if z is not None else None
            srt = apply_raw(lrt, zt)
            for i, c in enumerate(group):
                back = apply_code(srt[i * n : (i + 1) * n], INVERSE_CODE[c])
                out = back if out is None else out + back
        return out / 8.0

    return fwd
