"""Steps replayed as CUDA graphs: the port's counterpart of the JAX
package's one-program steps (``lax.scan`` over a chunk of train steps, a Z
search as one program).

A step of fixed shapes is captured once and replayed, so the host issues one
graph launch where it issued thousands of operations. Capture follows
PyTorch's recipe:

- the first call runs the step eagerly on a side stream (the warm-up: it
  builds the kernels with ``nvcc``, picks cuDNN's algorithms, fills the
  lazily built constants), and that call is a real step: its results are
  returned and its effects kept;
- then the step is captured (``torch.cuda.graph``, ``capture_error_mode=
  "thread_local"``) into a memory pool that every graph of one owner shares;
  capture records and runs nothing;
- later calls copy their inputs into the graph's static input buffers and
  replay it. What the step changes in place (weights, optimiser moments,
  BatchNorm statistics, a Z map) is held by address, so nothing may rebind
  those tensors; the owner drops its graphs when it loads new ones.

The kernels' launch counters count in Python, which a replay does not run:
what a capture counted is added again at each replay
(:data:`~esr_tpu_torch.ops.cuda.lib.LaunchCounter.all`), so the launches per
step read as they do eagerly.

A capture that fails raises with the reason; nothing falls back to eager. On
the CPU (and wherever graphs are off: several ranks) the same step runs
eagerly, the same code.

Spans (``utils/profiler.annotate``): ``graphs.copy_in`` (``StepGraphs.run``'s
copies into the static buffers), ``graphs.replay`` (a replay and its counter
deltas; it waits: the launch of a graph of thousands of kernels, a GAN step's
or a Z step's, blocks while the card drains its queue) and
``graphs.capture`` (the warm-up and the capture); an eager call has none.
"""

from __future__ import annotations

import time

import torch

from esr_tpu_torch.ops.cuda.lib import LaunchCounter
from esr_tpu_torch.utils.profiler import annotate

__all__ = ["GraphedStep", "StepGraphs"]


class GraphedStep:
    """``fn()``, a step on fixed buffers, replayed as one CUDA graph.

    ``enabled`` (on for a CUDA device; off, every call runs ``fn``
    eagerly): the first call runs it eagerly on a side stream and captures
    it; later calls replay and return the captured outputs (the same tensors
    each time, so a caller that keeps one past the next call copies it).
    ``pool``: a memory pool shared with other graphs of one owner, replayed
    one at a time."""

    def __init__(self, fn, device: torch.device, name: str, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.pool = pool
        self.enabled = self.device.type == "cuda"
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None
        self.deltas: list[tuple[LaunchCounter, int]] = []
        self.capture_seconds = 0.0

    def __call__(self):
        if not self.enabled:
            return self.fn()
        if self.graph is None:
            with annotate("graphs.capture"):
                return self._warm_up_and_capture()
        with annotate("graphs.replay", waits=True):  # the launch blocks while the card drains its queue
            self.graph.replay()
            for counter, d in self.deltas:
                counter.count += d
        return self.out

    def _warm_up_and_capture(self):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn()
        cur.wait_stream(side)
        before = [c.count for c in LaunchCounter.all]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                self.out = self.fn()
        except Exception as exc:
            raise RuntimeError(f"{self.name}: CUDA graph capture failed ({type(exc).__name__}: {exc}); "
                               "the step has no eager fallback on the card") from exc
        finally:
            after = [c.count for c in LaunchCounter.all]
            for c, n in zip(LaunchCounter.all, before):
                c.count = n  # capture launched nothing
        self.capture_seconds = time.perf_counter() - t0
        self.deltas = [(c, a - b) for c, a, b in zip(LaunchCounter.all, after, before) if a != b]
        self.graph = graph
        if self.pool is None:
            self.pool = graph.pool()
        return out


class StepGraphs:
    """One graph per key of ``fn(key, **inputs) -> outputs``, sharing one
    memory pool: ``run(key, inputs)`` copies the tensors of ``inputs`` into
    the static buffers of the graph for ``key`` and their shapes, and
    replays it (the first run of each warms up and captures); other values
    in ``inputs`` (None) are part of the key. ``enabled`` off: ``fn``
    eagerly. ``clear()`` drops every graph (after weights are loaded anew)."""

    def __init__(self, fn, device: torch.device, name: str, enabled: bool | None = None):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.enabled = self.device.type == "cuda" if enabled is None else enabled
        self._steps: dict = {}
        self._pool = None

    def run(self, key, inputs: dict):
        if not self.enabled:
            return self.fn(key, **inputs)
        with annotate("graphs.copy_in"):
            full = (key, *((k, tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else (k, v)
                           for k, v in sorted(inputs.items())))
            entry = self._steps.get(full)
            if entry is None:
                static = {k: v.to(self.device, copy=True) if isinstance(v, torch.Tensor) else v
                          for k, v in inputs.items()}
                fn = self.fn  # not self: no reference cycle keeps a dropped graph's pool alive
                step = GraphedStep(lambda: fn(key, **static), self.device, f"{self.name} [{key}]",
                                   pool=self._pool)
                self._steps[full] = entry = (step, static)
            else:
                for k, v in inputs.items():
                    if isinstance(v, torch.Tensor):
                        entry[1][k].copy_(v, non_blocking=True)
        out = entry[0]()
        self._pool = entry[0].pool
        return out

    @property
    def steps(self) -> list[GraphedStep]:
        """The captured steps (capture seconds, launches counted at capture)."""
        return [s for s, _ in self._steps.values()]

    def clear(self) -> None:
        self._steps.clear()
        self._pool = None
