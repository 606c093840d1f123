"""Check the PyTorch port on one NVIDIA GPU and print its kernel table.

    python3 chip_smoke.py

1. the card suite: ``python -m pytest --noconftest -m cuda -q`` over
   ``CARD_TESTS`` (it builds the kernels, reads their ptxas lines and holds
   each kernel and every path of the port against its plain version; the
   test modules that import JAX stay out, as the card's machine has none);
2. the main path's launches: every launch counter set to 0 just before one
   replay of each forward of ``PATHS`` (the configuration's generator with
   seeded weights behind the CEM, graphed by ``make_eval_forward``; its
   first call captures the graph);
3. ``conv_bench``'s rows in bf16 and on the f32 route: each kernel at its
   sites, ms beside its plain version, the library call and the bound.

Prints one ``{"kernels": [...], "card": ...}`` JSON line (a row a kernel:
its launches by path and its sites), then ``{"ok": true, "device": ...}``
when the suite passed and every kernel of the table launched on a path;
else exits 1. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
CARD_TESTS = ["tests/test_torch_cuda.py", *sorted(f"tests/{p.name}" for p in REPO.glob("tests/test_torch_card_*.py")),
              "tests/test_torch_swinir.py", "tests/test_torch_layernorm.py", "tests/test_torch_linear.py"]
# (path, configuration, LR batch (n, h, w), options changed): the eval cells'
# forwards, and the flagship's on the f32 route
PATHS = (("esr_eval", "esr_rrdb_x4_z1", (16, 128, 128), {}),
         ("esr_eval_f32", "esr_rrdb_x4_z1", (16, 128, 128), {"bf16": False}),
         ("srresnet_eval", "srresnet_x4_cem", (16, 128, 128), {}),
         ("swinir_eval", "swinir_m_x4_real", (4, 339, 510), {}))


@torch.no_grad()
def launches() -> dict[str, dict[str, int]]:
    """{path: {counter: launches in one replay}} for each forward of ``PATHS``."""
    from esr_bench.harness import load
    from esr_bench.traffic.eval import port_options
    from esr_tpu_torch.cem import CEMConf, make_cem
    from esr_tpu_torch.models.base_model import make_eval_forward
    from esr_tpu_torch.models.networks import define_G
    from esr_tpu_torch.ops.cuda.lib import LaunchCounter

    out = {}
    for name, config, shape, changed in PATHS:
        cfg = {**port_options(load("configs", config)), **changed}
        cem = make_cem(CEMConf(scale=cfg["scale"]), device="cuda")
        fwd = make_eval_forward(define_G(cfg, device="cuda", seed=0), cem)
        g = torch.Generator("cuda").manual_seed(0)
        nz = cfg["network_G"].get("num_latent_channels", 0)
        lr = torch.rand(*shape, 3, device="cuda", generator=g)
        z = torch.rand(*shape, nz, device="cuda", generator=g) * 2 - 1 if nz else None
        fwd(lr, z)
        torch.cuda.synchronize()
        for c in LaunchCounter.all:
            c.reset()
        fwd(lr, z)
        torch.cuda.synchronize()
        out[name] = {c.name: c.count for c in LaunchCounter.all if c.count}
        del fwd
        torch.cuda.empty_cache()
    return out


def main() -> int:
    from esr_tpu_torch.ops.cuda import conv_bench

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    suite = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-m", "cuda",
                            "-q", *CARD_TESTS], cwd=REPO).returncode
    by_path = launches()
    rows = conv_bench.table()[0] + conv_bench.table("f32")[0]
    kernels = [{"kernel": k, "launches_by_path": {p: n.get(k, 0) for p, n in by_path.items()},
                "sites": [r for r in rows if r["kernel"] == k]} for k in dict.fromkeys(r["kernel"] for r in rows)]
    print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    idle = [k["kernel"] for k in kernels if not any(k["launches_by_path"].values())]
    if suite or idle:
        print(f"card suite exit code {suite}; kernels launched on no path: {idle}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
