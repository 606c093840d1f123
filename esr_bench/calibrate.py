"""The readings that the check's limits are set from, for one cell:

    python3 esr_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3] [--seconds 2]

For each seed, in one process: the cell's set-up and a short window of its
own traffic, then the numbers its check compares (the lower readings); for
each control seed, the same numbers with the control (the reference in the
step below the configuration's precision) in the program's place, and with
each fault the traffic kind plants (``faults()``, where it has one): the
upper readings. One JSON line per reading; a card is required, as for a run.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from esr_bench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        bench = harness.Bench(args.workload, seed, "cuda", False)
        traffic = harness.module("traffic", bench.kind).Traffic(bench)
        t = time.perf_counter()
        traffic.setup()
        units, window_s = harness._window(traffic, args.seconds)
        traffic.release()
        gc.collect()
        torch.cuda.empty_cache()
        checks = traffic.judge()
        row = {"seed": seed, "side": "program", "units": units, "s": time.perf_counter() - t,
               **{name: value for name, value, _ in checks}}
        print(json.dumps(row), flush=True)
        if seed in args.control_seeds:
            sides = {"control": traffic.control()}
            if hasattr(traffic, "faults"):
                sides.update({f"fault.{k}": v for k, v in traffic.faults().items()})
            for side, checks in sides.items():
                row = {"seed": seed, "side": side, **{name: value for name, value, _ in checks}}
                print(json.dumps(row), flush=True)
        del traffic, bench
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
