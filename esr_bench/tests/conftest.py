"""Shared fixtures of the benchmark's own tests: the cells shrunk to a toy
width and size on the CPU, and ``card`` for the tests that need a CUDA card
(marked ``card``; they skip without one)."""

import copy

import pytest
import torch

from esr_bench import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


def shrink(kind: str, data: dict) -> dict:
    """A configuration or mix at a size the CPU runs in seconds, every shape
    rule kept, in float32 (the port's plain path then agrees with the
    reference to rounding, so a toy run is correct, and a fault or the
    control shows alone)."""
    d = copy.deepcopy(data)
    if kind == "configs":
        d["bf16"] = False
        d["network_G"].update(nf=8, nb=1, gc=4)
        if "network_D" in d:
            d["network_D"]["nf"] = 8
    elif kind == "traffic":
        if d["kind"] == "eval":
            d.update(lr_size=16, tiles=2, z_draws=min(d["z_draws"], 2), pool=2, trace_seconds=0.3)
        elif d["kind"] == "train":
            d.update(batch=2, hr_size=32, pool=4, trace_seconds=0.3)
        else:
            d.update(lr_size=32, boxes=4, box_min=5, box_max=16, z_steps=4, trace_seconds=0.3)
    return d


@pytest.fixture
def toy(monkeypatch):
    """The harness loads every cell, configuration and mix shrunk."""
    real = harness.load
    monkeypatch.setattr(harness, "load", lambda kind, name: shrink(kind, real(kind, name)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
