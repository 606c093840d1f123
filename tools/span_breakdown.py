"""One traced run of a benchmark cell with the port's spans laid over the
card's timeline: where the card idles, by what the host was doing.

    python tools/span_breakdown.py --workload <cell> --seed <n> --seconds <s> [--out <file.json>] [--device cpu]

Runs the cell as ``esr_bench/run.py --trace 1`` does (``harness.run``),
with the port's spans recorded in the untraced window too (``recording()``:
the host's clock alone, no profiler), and prints besides the run's own
result line, from the traced window:

- the card's idle seconds put down to ``<harness span>/<program span>``,
  the innermost span of the port open when each gap began
  (``esr_bench/program.idle_by_span``);
- each root name's host and wait milliseconds a unit, and each span name's
  count and milliseconds a unit;
- each ``LaunchCounter``'s delta over the window's roots beside the trace's
  records of its kernel (a record the profiler lost shows as a difference);

and from the untraced window each root name's host and wait milliseconds a
unit, and each span name's milliseconds a unit.

``--out`` also writes all of it as JSON. ``--device cpu`` rehearses it
without a card (no profile runs there, so wrap the call in
``profiler.recording()`` for the traced window's spans; the card is never
busy, so every gap is idle).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from esr_bench import harness, program  # noqa: E402

# a cell kind's roots, each with the harness span that calls it; the first is one a unit
ROOTS = {"eval": [("eval.forward", "forward")], "images": [("eval.forward", "forward")],
         "hat": [("eval.forward", "forward")],
         "train": [("train.step", "optimize_parameters"), ("train.losses", "log")],
         "clicks": [("explore.tool", "tool."), ("explore.render", "render")]}
OCCASIONAL = {"train.losses"}  # not every unit has one: the losses are fetched every print_freq steps
KERNELS = {"rdb5c_tc_kernel": ("rdb5c",), "conv_tc_kernel": ("conv3x3", "upsample2x_conv3x3"),
           "window_attn_kernel": ("window_attn",), "layernorm_kernel": ("layernorm",),
           "token_linear_kernel": ("token_linear",), "hat_attn_kernel<16>": ("hab_attn",),
           "hat_attn_kernel<24>": ("oca_attn",), "ca_pool_kernel": ("channel_attn",)}  # name: counters


def split(kind: str, recorded: list, units: int) -> tuple[dict, dict]:
    """The last ``units`` roots of each of the kind's root names (of an
    occasional one, those begun in the window): their count and host and
    wait ms a unit, each span name's count and ms a unit, and the roots'
    counter deltas; and the roots themselves."""
    out: dict = {"roots": {}, "names": {}, "counts": {}}
    roots_of = {}
    for name, _ in ROOTS[kind]:
        if name in OCCASIONAL:
            t0 = next(iter(roots_of.values()))[0].start_ns
            roots = [s for s in recorded if s.parent == -1 and s.name == name and s.start_ns >= t0]
        else:
            roots = program.window_roots(recorded, name, units)
            if not roots:
                raise ValueError(f"fewer than {units} {name} roots")
        roots_of[name] = roots
        host, wait = program.host_and_wait_ns(recorded, roots)
        out["roots"][name] = {"count": len(roots), "host_ms": host / 1e6 / units, "wait_ms": wait / 1e6 / units}
        for root, below in zip(roots, program.under(recorded, roots)):
            for s in [root, *below]:
                entry = out["names"].setdefault(s.name, {"count": 0, "ms_a_unit": 0.0, "waits": s.waits})
                entry["count"] += 1
                entry["ms_a_unit"] += (s.end_ns - s.start_ns) / 1e6 / units
            for counter, n in root.counts.items():
                out["counts"][counter] = out["counts"].get(counter, 0) + n
    return out, roots_of


def breakdown(kind: str, units: int, tr, events, marks) -> dict:
    recorded = program.spans()
    if not recorded:
        return {"error": "the port recorded no spans"}
    w0, w1 = harness.window_on_card(events, marks)
    try:
        out, roots_of = split(kind, recorded, units)
    except ValueError as exc:
        return {"error": str(exc)}
    name, caller = ROOTS[kind][0]
    offset = program.card_offset_us([s for s in tr.spans if s[0].startswith(caller)], roots_of[name])
    if offset is None:
        return {"error": f"{name} roots do not pair with the harness's {caller} spans"}
    on_card = [(s.name, s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset)
               for roots in roots_of.values() for root, below in zip(roots, program.under(recorded, roots))
               for s in [root, *below]]
    records: dict = defaultdict(int)
    for kname, _, _ in tr.kernels:
        for key in KERNELS:
            records[key] += key in kname
    out["counts_vs_records"] = {key: [sum(out["counts"].get(c, 0) for c in counters), records[key]]
                                for key, counters in KERNELS.items()}
    idle = program.idle_by_span(tr.busy, (w0, w1), tr.spans, on_card)
    out["idle_s"] = sorted(idle.items(), key=lambda kv: -kv[1])
    out["window_s"], out["busy_s"] = tr.window_s, tr.busy_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_breakdown: needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    from esr_tpu_torch.utils.profiler import recording

    seen: dict = {}
    traced, reduce, window = harness._traced_window, harness.reduce_trace, harness._window

    def record_untraced(traffic, seconds, first=0):
        if "untraced" in seen:
            return window(traffic, seconds, first)
        with recording() as rec:
            units, window_s = window(traffic, seconds, first)
        seen["untraced"] = {"units": units, "ms_a_unit": 1e3 * window_s / units, "dropped": rec.dropped,
                            **split(seen["kind"], rec.spans, units)[0]}
        return units, window_s

    def keep_reduce(events, spans, marks):
        seen.update(events=events, marks=marks)
        return reduce(events, spans, marks)

    def keep_window(bench, traffic, seconds, first):
        units, tr = traced(bench, traffic, seconds, first)
        seen["breakdown"] = breakdown(bench.kind, units, tr, seen["events"], seen["marks"])
        return units, tr

    harness.reduce_trace, harness._traced_window, harness._window = keep_reduce, keep_window, record_untraced
    seen["kind"] = harness.load("traffic", harness.load("workloads", args.workload)["traffic"])["kind"]
    try:
        result = harness.run(args.workload, args.seed, args.seconds, True, args.device, T_START)
    finally:
        harness.reduce_trace, harness._traced_window, harness._window = reduce, traced, window
    device = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    out = {"workload": args.workload, "seed": args.seed, "device": device,
           "metrics": result["metrics"], "correct": result["correct"], "breakdown": seen.get("breakdown"),
           "untraced": seen.get("untraced")}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
