"""Tracing, the port's spans and step timing (port of esr_tpu/utils/profiler.py).

``annotate(name, root=None, waits=False)`` is the port's span: a ``with``
block around one layer's part of a call (the names, and the metrics that
read them, are listed in PERF.md). Spans are recorded in memory while
recording is on: inside ``recording()``, and while a ``torch.profiler``
profile runs (torch's ``_is_profiler_enabled``, where the release has it),
so that a trace of the card can be read with the port's spans laid over it
(the benchmark's traced window). Otherwise ``annotate`` is a few flag tests
that return one shared no-op context: it allocates nothing, and no span
ever synchronises the card. A recorded :class:`Span` holds its name,
its start and end on ``time.perf_counter_ns()``, the span that encloses it
on its thread, its root's identifier (the root's ``root`` argument: a train
step's number, a forward's or a tool call's count; shared by the root's
descendants), ``waits`` (the host blocks on the card inside it: a fetch, a
synchronising copy) and, for a root, the deltas of the kernels' and loops'
``LaunchCounter``s over it. The buffer keeps the newest ``CAPACITY`` spans
and counts the ones it dropped; nothing is written to disk.

``trace(log_dir)`` captures a ``torch.profiler`` trace of a block (CPU
activity and, where CUDA is available, the card's kernels) and writes it as
``<log_dir>/trace.json`` (Chrome trace format: Perfetto or
``chrome://tracing``); the profile it yields gives ``key_averages()``
after the block. Inside it each span is also a ``record_function`` range
and, on CUDA, an NVTX range, so it shows on that timeline. On the H100 the
first ~40 kernels of a session were missing from its trace: run a step
before the steps to be read. ``StepTimer`` times steps with the warmup
discarded: on a CUDA device, by CUDA events around the step on that
device's stream (the end event synchronized); on the CPU, by the host clock.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["CAPACITY", "Recording", "Span", "StepTimer", "annotate", "recorded", "recording", "trace"]

CAPACITY = 1 << 16  # spans kept; a traced benchmark window records a few thousand
# torch's own flag while a profile runs, a private name: where a torch release lacks it, only
# ``recording()`` records
_TORCH_PROFILER = torch.autograd.profiler if hasattr(torch.autograd.profiler, "_is_profiler_enabled") else None


class Span(NamedTuple):
    id: int  # in order of opening
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: int  # the enclosing span's id; -1 for a root
    root: int  # the root's identifier, shared by its descendants
    waits: bool  # the host blocks on the card inside it
    counts: dict | None  # a root's LaunchCounter deltas (those that moved); None below a root


class Recording:
    """Spans, oldest first, and how many the buffer dropped (:func:`recording`, :func:`recorded`)."""

    def __init__(self, spans: list[Span] | None = None, dropped: int = 0):
        self.spans = spans or []
        self.dropped = dropped


class _Recorder:
    """The process's span buffer and the per-thread stacks of open spans.
    One per process, as the spans come from every layer of the port."""

    def __init__(self, capacity: int):
        self.spans: collections.deque[Span] = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.depth = 0  # open recording() blocks
        self.emit = False  # inside trace(): spans are record_function / NVTX ranges too
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(span)


_REC = _Recorder(CAPACITY)


_NO_SPAN = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "root", "waits", "id", "parent", "before", "ranges", "start")

    def __init__(self, name: str, root, waits: bool):
        self.name, self.root, self.waits = name, root, waits

    def __enter__(self):
        stack = _REC.stack()
        self.id = next(_REC.ids)
        if stack:
            self.parent, self.root, self.before = stack[-1].id, stack[-1].root, None
        else:
            self.parent = -1
            self.root = self.id if self.root is None else self.root
            self.before = [c.count for c in _counters()]
        self.ranges = _ranges(self.name) if _REC.emit else None
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter_ns()
        stack = _REC.stack()
        if stack and stack[-1] is self:
            stack.pop()
        counts = None
        if self.before is not None:
            counts = {c.name: c.count - n for c, n in zip(_counters(), self.before) if c.count != n}
        if self.ranges is not None:
            self.ranges.__exit__(exc_type, exc, tb)
        _REC.add(Span(self.id, self.name, self.start, end, self.parent, self.root, self.waits, counts))
        return False


def _counters() -> list:
    from esr_tpu_torch.ops.cuda.lib import LaunchCounter  # here: the ops package imports this module

    return LaunchCounter.all


def _ranges(name: str) -> contextlib.ExitStack:
    ranges = contextlib.ExitStack()
    ranges.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        ranges.enter_context(torch.cuda.nvtx.range(name))
    return ranges


def annotate(name: str, root=None, waits: bool = False):
    """A span named ``name`` around the block (see the module docstring).
    ``root``: the identifier a root span gives its descendants (its own id
    when None; ignored below a root); ``waits``: the host blocks on the card
    inside it."""
    if _REC.depth or (_TORCH_PROFILER is not None and _TORCH_PROFILER._is_profiler_enabled):
        return _OpenSpan(name, root, waits)
    return _NO_SPAN


@contextlib.contextmanager
def recording():
    """Record spans inside the block; the :class:`Recording` it yields holds
    them after the block (oldest first), and how many the buffer dropped."""
    rec = Recording()
    first, dropped = next(_REC.ids), _REC.dropped
    with _REC.lock:
        _REC.depth += 1
    try:
        yield rec
    finally:
        with _REC.lock:
            _REC.depth -= 1
            rec.spans = [s for s in _REC.spans if s.id > first]
            rec.dropped = _REC.dropped - dropped


def recorded() -> Recording:
    """Every span the buffer holds (oldest first), and how many it dropped."""
    with _REC.lock:
        return Recording(list(_REC.spans), _REC.dropped)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; the trace goes to ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    emit, _REC.emit = _REC.emit, True
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        _REC.emit = emit
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
