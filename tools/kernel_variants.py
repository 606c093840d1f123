"""Build variants of the port's CUDA kernels and time them in turns on one GPU.

    python tools/kernel_variants.py SPEC.json ORDER [--test-k EXPR] [--kernel NAME] [--f32 | --tiles] [--profile]

SPEC.json maps a variant name to a list of ``[file, old, new]`` text
replacements in the package (``old`` must occur exactly once; the specs of
``tools/rdb5c_variants/`` apply to this commit's sources). Each variant is a copy of ``esr_tpu_torch/`` and ``tests/`` in a
temporary directory; they are built two at a time (nvcc, one per source), then:

- the ptxas lines of the kernel named by ``--kernel`` (default
  ``rdb5c_tc_kernel``: registers, spills, C75xx serialization warnings) are
  printed per variant;
- a variant whose name does not start with ``x_`` must pass
  ``pytest --noconftest tests/test_torch_cuda.py -k EXPR`` (default
  ``rdb5c``); ``x_`` variants are timing probes that compute wrong results
  on purpose, and are not tested;
- ``python -m esr_tpu_torch.ops.cuda.conv_bench`` (with ``--f32``: its f32
  route; ``--tiles``: the RDB's tiles at small grids) runs in each directory
  in ORDER (comma-separated names, e.g. ``a,b,b,a``), so that versions are
  compared inside one process tree on one card;
- with ``--profile``, variants whose source defines ``esr_rdb5c_prof`` (see
  ``tools/rdb5c_variants/profile.json``) print the median clock cycles of
  each conv's MMA loop, epilogue and barrier in a tile, per warpgroup, at
  each ``NxHxW:TILE`` of ``--profile-at`` (nf 64 / gc 32).

Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = "esr_tpu_torch/ops/cuda/.torch_kernels_build"
BUILDS_AT_ONCE = 2
PROFILE = """
import ctypes, sys
import numpy as np, torch
from esr_tpu_torch.ops.cuda import lib, rdb_conv
from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_kernel_weights
g = torch.Generator("cuda").manual_seed(0)
p = {}
for k in range(1, 6):
    cin, cout = 64 + 32 * (k - 1), 64 if k == 5 else 32
    p[f"w{k}"] = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
    p[f"b{k}"] = torch.zeros(cout, device="cuda")
kw = rdb5c_kernel_weights(p, torch.bfloat16, torch.device("cuda"))
so = ctypes.CDLL(str(lib._lib_path("rdb5c")))
so.esr_rdb5c_prof.argtypes = [ctypes.c_void_p]
names = [f"c{k} {w}" for k in range(1, 6) for w in ("mma", "epilogue", "barrier")]
for case in sys.argv[1:]:  # NxHxW:TILE
    shape, tile = case.split(":")
    n, h, w = map(int, shape.split("x"))
    tile = int(tile)
    x = torch.randn(n, h, w, 64, device="cuda", generator=g).bfloat16()
    for _ in range(5):
        rdb_conv._launch(x, kw, tile)
    torch.cuda.synchronize()
    buf = np.zeros((132, 2, 16), dtype=np.int64)
    assert so.esr_rdb5c_prof(buf.ctypes.data) == 0
    blocks = min(132, n * -(-h // tile) * -(-w // tile))
    med = np.median(buf[:blocks] - buf[:blocks, :, :1], axis=0)
    for grp in range(2):
        steps = [f"{nm} {med[grp, i + 1] - med[grp, i]:.0f}" for i, nm in enumerate(names)]
        print(f"PROFILE {case} group {grp}: tile {med[grp, 15]:.0f} clk | " + " | ".join(steps), flush=True)
"""


def make_variant(d: Path, reps: list) -> None:
    for sub in ("esr_tpu_torch", "tests"):
        shutil.copytree(ROOT / sub, d / sub, ignore=shutil.ignore_patterns(".torch_kernels_build", "__pycache__"))
    for f, old, new in reps:
        p = d / f
        s = p.read_text()
        if s.count(old) != 1:
            raise SystemExit(f"{d.name}: {f}: the text to replace occurs {s.count(old)} times: {old[:80]!r}")
        p.write_text(s.replace(old, new))


def ptxas_lines(d: Path, kernel: str) -> list[str]:
    out = []
    for log in sorted((d / BUILD).glob("lib*.log")):
        lines = log.read_text().splitlines()
        out += [ln for ln in lines if "C75" in ln and kernel in ln]
        for i, ln in enumerate(lines):
            if "Function properties" in ln and kernel in ln:
                out += [ln.split()[-1][:60]] + [x.strip() for x in lines[i + 1:i + 3]]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("spec")
    ap.add_argument("order")
    ap.add_argument("--test-k", default="rdb5c")
    ap.add_argument("--kernel", default="rdb5c_tc_kernel", help="the kernel whose ptxas lines are printed")
    ap.add_argument("--f32", action="store_true", help="time conv_bench's f32 route")
    ap.add_argument("--tiles", action="store_true", help="time conv_bench's RDB tiles at small grids")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--profile-at", default="16x128x128:16", help="comma-separated NxHxW:TILE to profile")
    args = ap.parse_args()
    spec = json.loads(Path(args.spec).read_text())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for name, reps in spec.items():
            dirs[name] = Path(tmp) / name
            make_variant(dirs[name], reps)
        ok = {}
        names = list(dirs)
        for i in range(0, len(names), BUILDS_AT_ONCE):  # each build runs one nvcc per source
            batch = {n: subprocess.Popen([sys.executable, "-c", "from esr_tpu_torch.ops.cuda import lib; lib.build_all()"],
                                         cwd=dirs[n], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for n in names[i:i + BUILDS_AT_ONCE]}
            for n, proc in batch.items():
                log, _ = proc.communicate()
                ok[n] = proc.returncode == 0
                print(f"== build {n}: rc {proc.returncode}", *ptxas_lines(dirs[n], args.kernel), sep="\n  ",
                      flush=True)
                if not ok[n]:
                    print(log[-3000:], flush=True)
        for n, d in dirs.items():
            if not ok[n] or n.startswith("x_"):
                continue
            r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "tests/test_torch_cuda.py", "-q",
                                "-x", "-k", args.test_k, "-p", "no:warnings"],
                               cwd=d, capture_output=True, text=True, timeout=600)
            ok[n] = r.returncode == 0
            tail = r.stdout.strip().splitlines()[-1:] if ok[n] else [r.stdout[-2500:]]
            print(f"== test {n}: rc {r.returncode}", *tail, flush=True)
        for n in args.order.split(","):
            if n not in dirs or not ok[n]:  # x_ variants: built; the others: tested
                continue
            mode = ["--f32"] * args.f32 + ["--tiles"] * args.tiles
            r = subprocess.run([sys.executable, "-m", "esr_tpu_torch.ops.cuda.conv_bench"] + mode,
                               cwd=dirs[n], capture_output=True, text=True, timeout=600)
            print(f"== bench {n}:", r.stdout.strip()[-1200:], r.stderr[-1500:] if r.returncode else "", flush=True)
        if args.profile:
            for n, d in dirs.items():
                if ok[n] and "esr_rdb5c_prof" in (d / "esr_tpu_torch/ops/cuda/csrc/rdb5c.cu").read_text():
                    r = subprocess.run([sys.executable, "-c", PROFILE, *args.profile_at.split(",")], cwd=d,
                                       capture_output=True, text=True,
                                       timeout=600)
                    print(f"== profile {n}:", r.stdout.strip(), r.stderr[-1500:] if r.returncode else "", flush=True)


if __name__ == "__main__":
    main()
