"""The benchmark of esr_tpu_torch, the PyTorch and CUDA port, on NVIDIA cards.

    python3 esr_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the cards of this machine: set-up
(weights and inputs made on the card from ``--seed``, the cell's shapes
warmed, its CUDA graphs captured), a timed window of ``--seconds``, then
the check of the window's answers against the plain reference. ``--trace
0`` reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones
from a profiler trace of the window. The last line of standard output is
the result as one JSON object; the last lines of standard error give each
number the check compared beside its limit.

The run fails, and prints no result, without enough CUDA cards (there is no
CPU fallback), without the port beside this folder, or if JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from esr_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    chips = int(harness.load("workloads", args.workload)["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"esr_bench: {args.workload} needs {chips} CUDA card(s), this machine has {have}", file=sys.stderr)
        return 2
    try:
        import esr_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"esr_bench: the port esr_tpu_torch is not importable beside this folder ({exc})", file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"esr_bench: the run loaded JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
