"""Tracing and step timing (port of esr_tpu/utils/profiler.py).

``trace(log_dir)`` captures a ``torch.profiler`` trace of a block (CPU
activity and, where CUDA is available, the card's kernels) and writes it as
``<log_dir>/trace.json`` (Chrome trace format: Perfetto or
``chrome://tracing``); the profile it yields gives ``key_averages()``
after the block. On the H100 the first ~40 kernels of a session were
missing from its trace: run a step before the steps to be read. ``annotate(name)`` names a region on that timeline (a
``record_function`` range, and an NVTX range on CUDA). ``StepTimer`` times
steps with the warmup discarded: on a CUDA device, by CUDA events around
the step on that device's stream (the end event synchronized); on the CPU,
by the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["StepTimer", "annotate", "trace"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; the trace goes to ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region on the trace's timeline (and on the card's, by NVTX)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class StepTimer:
    """Step timing with the first ``warmup`` steps discarded; ``device``: the
    device the steps run on (a CUDA device is timed by events on its current
    stream, anything else by the host clock)."""

    def __init__(self, warmup: int = 1, device: str | torch.device | None = None):
        self.warmup = warmup
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.times: list[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self, result_to_fence=None):  # noqa: ARG002 — the JAX API's fence: events fence here
        """Time the block; ``yield``s a dict (the JAX API's ``out['fence']``
        is accepted and not needed: the end event or the host clock fences)."""
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record(stream)
        t0 = time.perf_counter()
        yield {}
        if cuda:
            e1.record(stream)
            e1.synchronize()
            dt = e0.elapsed_time(e1) / 1e3
        else:
            dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        """Seconds per timed step (NaN before one is timed)."""
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def rate(self, items_per_step: float = 1.0) -> float:
        return items_per_step / self.mean if self.times else float("nan")
