"""The port's ``utils/checks.py`` and ``utils/profiler.py`` against the JAX
package's on the CPU: the non-finite scan reports the same key paths on the
same nested tree; ``assert_finite``, ``checkify_step`` and ``assert_pure``
raise where JAX's do; ``StepTimer`` discards its warmup and reports mean
and rate; ``trace`` writes a Chrome trace holding an ``annotate`` region."""

from __future__ import annotations

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.utils.checks import find_nonfinite as jfind_nonfinite
from esr_tpu_torch.utils import checks
from esr_tpu_torch.utils.profiler import StepTimer, annotate, trace


def _tree(lib):
    nan, inf = float("nan"), float("inf")
    return {"G": [lib.ones(3), lib.asarray([1.0, nan])], "D": (lib.asarray([inf]), {"ok": lib.zeros(2)}),
            "step": lib.asarray([1, 2]), "lr": 0.1}


def test_find_nonfinite_matches_jax():
    want = jfind_nonfinite(_tree(jnp))
    assert checks.find_nonfinite(_tree(torch)) == want == ["['D'][0]", "['G'][1]"]
    assert checks.find_nonfinite({"a": np.array([np.nan]), "b": float("inf")}) == ["['a']", "['b']"]
    checks.assert_finite({"a": torch.ones(2)})
    with pytest.raises(FloatingPointError, match=r"\['D'\]\[0\]"):
        checks.assert_finite(_tree(torch), "step outputs")


def test_checkify_step_names_nonfinite_outputs():
    step = checks.checkify_step(lambda x: {"loss": torch.log(x), "n": x.numel()})
    err, out = step(torch.ones(2))
    assert err.get() is None and torch.equal(out["loss"], torch.zeros(2))
    err.throw()
    err, _ = step(torch.tensor([1.0, 0.0]))
    with pytest.raises(FloatingPointError, match=r"\['loss'\]"):
        err.throw()


def test_assert_pure():
    checks.assert_pure(lambda x, y: (x * 2, {"s": y.sum()}), torch.arange(4.0), np.ones(3))
    state = {"n": 0}

    def impure(x):
        state["n"] += 1
        return x + state["n"]

    with pytest.raises(AssertionError, match="not pure"):
        checks.assert_pure(impure, torch.zeros(2))
    checks.assert_pure(impure, torch.zeros(2), atol=1.0)


def test_step_timer_discards_warmup():
    timer = StepTimer(warmup=2)
    assert np.isnan(timer.mean) and np.isnan(timer.rate())
    for dt in (0.05, 0.05, 0.01, 0.01, 0.01):
        with timer.step() as out:
            time.sleep(dt)
            out["fence"] = None
    assert len(timer.times) == 3
    assert 0.01 <= timer.mean < 0.04, timer.times
    assert timer.rate(10) == pytest.approx(10 / timer.mean)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path)) as prof:
        with annotate("probe_region"):
            (x @ x).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "probe_region" for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
