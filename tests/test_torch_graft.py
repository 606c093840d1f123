"""The port's compile-and-run entry (``esr_tpu_torch/graft_entry.py``) on
the CPU: ``entry`` builds the flagship forward and its example arguments
(the forward run here on a crop of them, bf16 on the plain path; the card
test runs the whole), and ``dryrun_multichip(2)`` runs every check of the
JAX package's dry run over two gloo ranks under its timeout, and raises
with the ranks' report when they fail."""

from __future__ import annotations

import pytest
import torch

from esr_tpu_torch import graft_entry
from esr_tpu_torch.cem import CEMConf, make_cem


def test_entry_builds_the_flagship_forward():
    fn, (lr, z) = graft_entry.entry(device="cpu")
    assert tuple(lr.shape) == (2, 64, 64, 3) and tuple(z.shape) == (2, 64, 64, 1)
    assert not z.any() and 0 <= lr.min() and lr.max() <= 1
    out = fn(lr[:1, :8, :8], z[:1, :8, :8])
    assert tuple(out.shape) == (1, 32, 32, 3) and out.dtype == torch.float32 and torch.isfinite(out).all()
    residual = (make_cem(CEMConf(scale=4), device="cpu").downsample(out) - lr[:1, :8, :8]).abs().max().item()
    assert residual <= 1e-5


def test_dryrun_multichip_two_ranks(capsys):
    graft_entry.dryrun_multichip(2, timeout=240.0)
    assert "dryrun_multichip(2) OK" in capsys.readouterr().out


def test_dryrun_multichip_reports_failures():
    with pytest.raises(ValueError, match="power of two"):
        graft_entry.dryrun_multichip(3)
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(2\) failed:\n.*still running"):
        graft_entry.dryrun_multichip(2, timeout=0.5)
