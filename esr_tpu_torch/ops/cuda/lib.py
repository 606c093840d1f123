"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Builds happen at
first use, all sources in parallel, into ``.torch_kernels_build/`` beside
this file (git-ignored); a library's file name carries a hash of the sources
it was built from, so an edited source is rebuilt and a stale one never
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "LaunchCounter", "aligned16", "build_all", "check", "forward_only", "load",
    "mma_channels_ok", "mma_fragments", "ptr", "stream",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".torch_kernels_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_VP, _I, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
# C signatures of the kernels' entry points, by library
_SIGNATURES = {
    "rdb5c": {
        "esr_rdb5c": ([_I] + [_VP] * 12 + [_I] * 7 + [_VP], _I),
        "esr_rdb5c_smem_bytes": ([_I] * 5, _SZ),
    },
    "conv3x3": {
        "esr_conv": ([_I] + [_VP] * 4 + [_I] * 9 + [_VP], _I),
        "esr_conv_smem_bytes": ([_I] * 4, _SZ),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Counts the launches of one kernel; the wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first use and need the CUDA toolkit")
    return found


def build_all() -> float:
    """Build every kernel library that is missing, one nvcc per source, all at
    once, and return the wall seconds it took (0 if nothing was built). Each
    library's ptxas report (registers, shared memory, spills) is kept beside
    it as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in _SIGNATURES if not _lib_path(n).exists()}
    if not todo:
        return 0.0
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.esr_error_string.argtypes = [_I]
            lib.esr_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int | None:
    """The current CUDA stream of ``t``'s device, as the C interface takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream if t.is_cuda else None


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernels' vector loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def mma_channels_ok(c: int) -> bool:
    """Whether a bf16 feature of ``c`` channels fits the tensor-core kernels'
    swizzled shared-memory layout: 16-byte chunks per pixel 2, 4 or a multiple of 8."""
    return c % 16 == 0 and (c // 8 in (2, 4) or c % 64 == 0)


def mma_fragments(w: torch.Tensor) -> torch.Tensor:
    """B matrices [..., K, N] (K % 16 == 0, N % 8 == 0) -> mma.sync m16n8k16
    B-fragment order [..., K/16, N/8, lane, 4]: lane = 4 * (n % 8) + (k % 8) // 2
    holds B[k0 + 2 (lane % 4) + {0, 1}, n] and B[k0 + 8 + 2 (lane % 4) + {0, 1}, n],
    so that each lane's fragment is one 8-byte load."""
    *lead, k, n = w.shape
    t = w.reshape(*lead, k // 16, 2, 4, 2, n // 8, 8)  # kb, k-half, k-quad, k-pair, nb, n
    d = len(lead)
    return t.permute(*range(d), *(d + i for i in (0, 4, 5, 2, 1, 3))).contiguous()


def forward_only(what: str, *tensors: torch.Tensor | None) -> None:
    """The kernels have no backward: refuse inputs that autograd would track."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel is forward-only; call it under torch.no_grad()")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.esr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
