"""The harness: finds a cell's files by name, makes its weights and inputs
from the seed, runs set-up, the timed window and the check, reads the
per-layer metrics from a trace, and assembles the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
sits in a file of its own, found by name:

- ``workloads/<cell>.json``: its configuration, traffic mix, chips, why,
  and the limits of the numbers its check compares;
- ``configs/<config>.json``: the configuration as the port's options take
  it, with its source, what was ``reduced`` and what was ``assumed``;
- ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  generator, ``traffic/<kind>.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns None where it finds nothing to read.

A traffic kind's module holds a class ``Traffic(bench)`` with ``SPANS``
(the names of its spans), ``setup()``, ``unit(i)`` (enqueue the i-th unit
of work: a forward, a step, a click; set-up and warm units are numbered
below 0), ``drain()`` (wait for the card), ``end_to_end(units, window_s)``,
``counts(units)`` (what the metrics read), ``release()`` (free the
program's state), ``judge()`` (the check: ``[(name, value, limit)]``, and
``failed``), and for ``calibrate.py`` ``control()`` (the same check with the
control in the program's place) and, for training, ``faults()``.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import importlib.util
import json
import sys
import time
import traceback
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["BENCH", "Bench", "FORBIDDEN", "forbidden_modules", "load", "run"]

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "esr_tpu")
WARM_UNITS = 2  # units run under the profiler before its window: a trace misses a session's first kernels
MARK = "spin_kernel"  # torch.cuda._sleep's kernel, which marks the traced window's ends on the card
MARK_CYCLES = (1_000, 100_000)  # the start marker spins ~0.6 us, the end marker ~60 us: told apart by length
MARK_END_US = 10.0  # a marker that lasts longer than this is the end marker


def load(kind: str, name: str) -> dict:
    """The JSON file ``<kind>/<name>.json`` of the benchmark."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def module(kind: str, name: str):
    """The Python file ``<kind>/<name>.py``, imported by path (a name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"esr_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed (weights, inputs, samples)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32 & 0xFFFFFFFF] + [ord(c) for c in tag]
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 31 | int(lo) >> 1) & (2**63 - 1)


class Bench:
    """What a traffic kind is handed: the cell, its configuration and mix,
    the seed, the device, and ``span(name)`` around each call into the
    port (timed on the host clock when tracing, else nothing)."""

    def __init__(self, cell: str, seed: int, device: str, trace: bool):
        self.cell = cell
        self.workload = load("workloads", cell)
        self.cfg = load("configs", self.workload["config"])
        self.mix = load("traffic", self.workload["traffic"])
        self.kind = self.mix["kind"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.tracing = trace
        self.spans: list[tuple[str, float, float]] = []  # (name, host start s, host end s), traced run

    def generator(self, tag: str) -> torch.Generator:
        """A generator on the device, seeded from the run's seed and ``tag``."""
        return torch.Generator(self.device).manual_seed(sub_seed(self.seed, tag))

    def weights(self, shapes: dict, tag: str) -> dict[str, torch.Tensor]:
        """``{key: tensor}`` for ``shapes`` (``{key: (shape, gain)}``): one
        normal draw on the device in float32, the type the port serves its
        parameters in, cut and scaled: Kaiming (fan in) times ``gain`` for a
        weight, ``gain`` for a bias."""
        sizes = [int(np.prod(s)) for s, _ in shapes.values()]
        flat = torch.randn(sum(sizes), generator=self.generator(tag), device=self.device)
        out, at = {}, 0
        for (key, (shape, gain)), n in zip(shapes.items(), sizes):
            std = gain * (2.0 / int(np.prod(shape[1:]))) ** 0.5 if len(shape) > 1 else gain
            out[key] = flat[at : at + n].view(shape).mul_(std)
            at += n
        return out

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.tracing:
            yield
            return
        t = time.perf_counter()
        yield
        self.spans.append((name, t, time.perf_counter()))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _window(traffic, seconds: float, first: int = 0) -> tuple[int, float]:
    """Units ``first``, ``first + 1``, ... enqueued until ``seconds`` have
    passed, and at least the traffic's ``MIN_UNITS`` (those its check
    reads), then the card drained: (units completed, seconds from the first
    enqueue to the drain's end)."""
    n, t0 = 0, time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline or n < getattr(traffic, "MIN_UNITS", 1):
        traffic.unit(first + n)
        n += 1
    traffic.drain()
    return n, time.perf_counter() - t0


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def mark(bench: Bench, end: bool) -> float:
    """Enqueue a marker on the idle card, a spin kernel, short at the
    window's start and long at its end, and return the host time just
    before: the marker's start in the trace ties the card's clock to the
    host's."""
    t = time.perf_counter()
    if bench.device.type == "cuda":
        torch.cuda._sleep(MARK_CYCLES[int(end)])
    return t


def device_events(prof) -> list[tuple[str, float, float]]:
    """``(name, start_us, end_us)`` of the card's kernels, copies and fills
    in a profile, read from the profiler's results in memory (no trace file
    is written: a traced Z search records hundreds of thousands of kernels)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
            continue
        start = e.start_ns() / 1e3
        out.append((e.name(), start, start + e.duration_ns() / 1e3))
    return out


def window_on_card(events, marks: tuple[float, float]) -> tuple[float, float]:
    """The traced window's start and end on the card's clock (us), from the
    start and end markers (``marks``: their host times). The profiler can
    lose a record: where one marker is missing, the other and the host's
    length of the window place it (the host's clock is good to well under
    a millisecond, against a window of seconds). With no card's events (a
    run on the CPU), the window is the host's."""
    h0, h1 = marks
    if not events:
        return 0.0, (h1 - h0) * 1e6
    found = [(a, b - a) for name, a, b in events if MARK in name]
    starts = sorted(a for a, dur in found if dur <= MARK_END_US)
    ends = sorted(a for a, dur in found if dur > MARK_END_US)
    if len(starts) > 1 or len(ends) > 1 or not found:
        raise RuntimeError(f"the trace holds {len(starts)} start and {len(ends)} end {MARK} markers, not one each")
    if len(found) < 2:
        print(f"esr_bench: the trace lost the {'end' if starts else 'start'} marker; the host clock places it",
              file=sys.stderr)
    w0 = starts[0] if starts else ends[0] - (h1 - h0) * 1e6
    w1 = ends[0] if ends else w0 + (h1 - h0) * 1e6
    return w0, w1


def reduce_trace(events, spans, marks: tuple[float, float]) -> SimpleNamespace:
    """The card's work between the two markers (``marks``: their host
    times): its operations ``[(name, start_us, dur_us)]``, the merged busy
    intervals, the harness spans ``[(name, start_us, end_us)]`` moved onto
    the card's clock, busy and window seconds, the ten operations that took
    most time, and the ten longest idle gaps summed by the harness span
    that was open on the host when each began. With no card's events (a
    run on the CPU), the window is the host's and nothing was busy."""
    h0, h1 = marks
    w0, w1 = window_on_card(events, marks)
    device = [(name, a, b) for name, a, b in events if MARK not in name and w0 <= a < w1]
    kernels = [(name, a, b - a) for name, a, b in device]
    busy = _merge([(a, min(b, w1)) for _, a, b in device])
    by_op: dict[str, float] = defaultdict(float)
    for name, a, b in device:
        by_op[short_name(name)] += (b - a) / 1e6
    on_card = sorted((w0 + (a - h0) * 1e6, w0 + (b - h0) * 1e6, name) for name, a, b in spans if a >= h0)
    starts = [a for a, _, _ in on_card]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    by_span: dict[str, float] = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:  # the harness's spans do not nest: the last one begun before the gap, if still open
            j = bisect.bisect_right(starts, a) - 1
            by_span[on_card[j][2] if j >= 0 and a < on_card[j][1] else "(no span)"] += (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return SimpleNamespace(kernels=kernels, busy=busy, spans=[(n, a, b) for a, b, n in on_card],
                           busy_s=sum(b - a for a, b in busy) / 1e6, window_s=(w1 - w0) / 1e6,
                           host_window_s=h1 - h0, device_ops=top(by_op), idle_gaps=top(by_span))


def short_name(name: str) -> str:
    """A kernel's name without its argument list (its template arguments kept)."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:160]


def _per_layer(bench: Bench, traffic, units: int, tr: SimpleNamespace, clean: SimpleNamespace) -> dict:
    """Each metric reader's reading of ``ctx``: the traced window's card
    (``kernels``, ``busy``, ``spans``, ``busy_s``, ``window_s``, ``counts``
    of its ``units``) and the untraced window (``clean``: its ``units`` and
    ``window_s``; ``clean_counts``)."""
    ctx = SimpleNamespace(kind=bench.kind, cfg=bench.cfg, mix=bench.mix, counts=traffic.counts(units), units=units,
                          kernels=tr.kernels, busy=tr.busy, spans=tr.spans, busy_s=tr.busy_s, window_s=tr.window_s,
                          clean=clean, clean_counts=traffic.counts(clean.units))
    out = {}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        reader = module("metrics", path.stem)
        value = reader.read(ctx)
        if value is not None:
            out[path.stem] = {"value": value, "unit": reader.UNIT}
    return out


def _traced_window(bench: Bench, traffic, seconds: float, first: int) -> tuple[int, SimpleNamespace]:
    """Units ``first``, ... for ``seconds`` under the profiler, which records
    the card's operations alone, after ``WARM_UNITS`` it also records, and
    the trace reduced (``reduce_trace``): (units, the reduction)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = bench.device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA]) if on_card else contextlib.nullcontext() as prof:
        for i in range(WARM_UNITS):
            traffic.unit(-1 - i)
        traffic.drain()
        bench.spans.clear()
        h0 = mark(bench, end=False)
        units, _ = _window(traffic, seconds, first=first)
        h1 = mark(bench, end=True)
        if on_card:  # the end marker is not the trace's last record
            torch.zeros(1, device=bench.device)
        bench.sync()
    events = device_events(prof) if on_card else []
    print(f"esr_bench: the trace holds {len(events)} operations on the card", file=sys.stderr)
    return units, reduce_trace(events, bench.spans, (h0, h1))


def run(cell: str, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """One run of ``cell``; ``t_start``: the process's start on the host clock."""
    bench = Bench(cell, seed, device, trace)
    traffic = module("traffic", bench.kind).Traffic(bench)
    t_setup = time.perf_counter()
    traffic.setup()
    bench.sync()
    phases = {"before": t_setup - t_start, "traffic": time.perf_counter() - t_setup,
              **getattr(traffic, "setup_phases", {})}
    print(f"esr_bench: set-up seconds {json.dumps(phases)}", file=sys.stderr)
    result: dict = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        # Two windows: one of ``seconds`` at the host's own speed, as a run with --trace 0 has,
        # then one of trace_seconds that records the card's timeline. The profiler slows the
        # host's launches (by ~15-20% in the train step), so what depends on the host's speed
        # is read from the first, and what the card did from the second.
        clean_units, clean_s = _window(traffic, seconds)
        clean = SimpleNamespace(units=clean_units, window_s=clean_s)
        for attempt in (1, 2):  # a profiler that fails, or a trace that cannot be read, is traced once more
            try:
                units, tr = _traced_window(bench, traffic, min(seconds, float(bench.mix["trace_seconds"])),
                                           clean_units)
                break
            except Exception:
                if attempt == 2:
                    raise
                traceback.print_exc()
                print("esr_bench: the traced window failed; it is traced once more", file=sys.stderr)
        print(f"esr_bench: {1e3 * clean_s / clean_units!r} ms a unit untraced ({clean_units} units), "
              f"{1e3 * tr.host_window_s / units!r} traced ({units} units; the window {tr.window_s!r} s on "
              f"the card, {tr.host_window_s!r} s on the host)", file=sys.stderr)
        result["metrics"] = _per_layer(bench, traffic, units, tr, clean)
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        busy = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        units += clean_units
    else:
        setup_s = time.perf_counter() - t_start
        units, window_s = _window(traffic, seconds)
        result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in traffic.end_to_end(units, window_s).items()}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        busy, breakdown = {}, None
    result["attempted"] = units
    peak = torch.cuda.max_memory_allocated(bench.device) if bench.device.type == "cuda" else 0
    traffic.release()
    gc.collect()
    if bench.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = traffic.judge()
    result["failed"] = traffic.failed
    result["correct"] = all(value <= limit for _, value, limit in checks) and traffic.failed == 0
    n_dev = int(bench.workload["chips"])
    result["device"] = {
        "platform": "gpu" if bench.device.type == "cuda" else bench.device.type,
        "kind": torch.cuda.get_device_name(bench.device) if bench.device.type == "cuda" else "cpu",
        "count": n_dev, "memory_peak_bytes": int(peak), **busy,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result

