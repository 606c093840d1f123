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
    "LaunchCounter", "aligned16", "build_all", "check", "forward_only", "load", "ptr", "stream",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".torch_kernels_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_VP, _I, _LL, _SZ, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t, ctypes.c_float
# C signatures of the kernels' entry points, by library
_SIGNATURES = {
    "rdb5c": {
        "esr_rdb5c": ([_VP] * 8 + [_I] * 6 + [_VP], _I),
        "esr_rdb5c_smem_bytes": ([_I] * 3, _SZ),
        "esr_rdb5c_weight_image_bytes": ([_I] * 3, _SZ),
    },
    "conv3x3": {
        "esr_conv": ([_VP] * 4 + [_I] * 9 + [_VP], _I),
        "esr_conv_f32": ([_VP, _I, _I] * 2 + [_VP] * 3 + [_I, _I, _VP, _I, _F] + [_I] * 7 + [_VP], _I),
    },
    "window_attn": {
        "esr_window_attn": ([_VP] * 3 + [_I] * 6 + [_F, _VP], _I),
        "esr_window_attn_smem_bytes": ([_I] * 2, _SZ),
    },
    "layernorm": {
        "esr_layernorm": ([_VP] * 4 + [_LL, _I, _F, _I, _VP], _I),
    },
    "token_linear": {
        "esr_token_linear": ([_VP] * 5 + [_LL] + [_I] * 4 + [_VP], _I),
    },
    "hat_attn": {
        "esr_hat_attn": ([_VP] * 3 + [_I] * 7 + [_F, _VP], _I),
    },
    "channel_attn": {
        "esr_channel_attn": ([_VP] * 10 + [_I] * 7 + [_F, _VP], _I),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Counts the launches of one kernel route (the wrapper adds one per
    launch), the weight layouts built for a kernel, or the steps of a graphed
    loop (``explore/z_optimizer.Z_STEPS``). Every counter made is listed in
    :data:`LaunchCounter.all` (a CUDA graph's replay adds what its capture
    counted: ``utils/graphs.py``; a root span records their deltas:
    ``utils/profiler.py``)."""

    all: list["LaunchCounter"] = []

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        LaunchCounter.all.append(self)

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


def forward_only(what: str, *tensors: torch.Tensor | None) -> None:
    """The kernels have no backward: refuse inputs that autograd would track."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel is forward-only; call it under torch.no_grad()")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.esr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
