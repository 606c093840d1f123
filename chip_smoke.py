"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: torch / CUDA versions, compute capability, card name and
   power limit; TF32 off for every f32 comparison;
2. build the hand-written CUDA kernels (nvcc, sm_90a) from the checkout;
3. hold each kernel against its plain PyTorch version on the card, at the
   flagship widths and main-path shapes: the bf16 tensor-core kernels the
   main path runs (with a band shown to see a faulty RDB kernel), the RDB
   kernel on ragged grids, batch 1 and an image smaller than a tile, the conv
   kernel on ragged grids, batch 1, Cin 4 and Cout 3 in both modes, and the
   f32 SIMT kernels of the same sources; time each kernel with its weight
   layout built once (as the forward runs it), its plain version and the
   library call with CUDA events, per conv site (one ``{"kernels": [...]}``
   JSON line);
4. answer requests through the CEM-wrapped flagship forward
   (RRDBNet nf=64 nb=23 gc=32 x4 nz=1, bf16 kernels, seeded Kaiming weights):
   shape, finiteness, CEM residual, Z diversity, launch counts, PSNR against
   the f32 plain path beside the bf16 plain path's; plus an f32 kernel-path
   forward against the f32 plain path at nb=2;
5. time the flagship forward at B16 x LR 128: kernel path, kernel path with
   the weight layout rebuilt in every call, and bf16 plain path; profile
   two kernel-path forwards (device time by kernel, busy share, the RDB
   kernel's time per forward, the conv kernel's beside the library calls');
6. the eval CLI (``esr_tpu_torch.test.main``) at the flagship width on the
   weights of ``define_G(seed=0)`` loaded back from a ``.pth``: a SYNTHETIC
   set (4 images, HR 512) and a folder of PNGs written by the port's codec
   (a DIV2K-sized HR 2040x1356, LR 510x339, and a ragged HR 406x301:
   modcrop, then ``eval_pad_bucket`` 32), two Z draws; serially, with
   ``eval_batch`` 4, and the DIV2K-sized image with ``self_ensemble``:
   launches per forward, CEM residual of every draw, batched == serial, the
   saved PNGs == the SR uint8, the DIV2K-sized image's PSNR against the f32
   plain path beside the bf16 plain path's, ms per image per draw;
7. serving: export buckets 1x64x64, 1x128x128, 1x96x96, start the HTTP
   server in a thread, GET /healthz, POST /sr (zeros Z, seeded random Z
   twice and another seed, a junk body, an image too large): each answer
   equal to the live Servable's and to the forward on the padded LR cropped
   back, launches and latency per request, export time.

Every phase counts the kernel launches of the path it drives (counters set
to 0 just before, read just after). The last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from esr_tpu_torch import test as eval_cli
from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.data import create_dataset, png
from esr_tpu_torch.data.lrhr_dataset import SyntheticDataset
from esr_tpu_torch.data.util import read_img_uint8, save_img
from esr_tpu_torch.export import export_servable
from esr_tpu_torch.models import create_model, define_G, make_eval_forward
from esr_tpu_torch.models.blocks import upsample_nearest
from esr_tpu_torch.ops import tensor2img
from esr_tpu_torch.ops.cuda import kpack_conv, lib, rdb_conv
from esr_tpu_torch.ops.cuda.kpack_conv import (
    conv3x3_reference,
    conv_kernel_weights,
    conv_launch,
    kpack_conv3x3,
)
from esr_tpu_torch.ops.cuda.rdb_conv import (
    fused_rdb5c,
    fused_rdb5c_tiled,
    rdb5c_kernel_weights,
    rdb5c_launch,
    rdb5c_params_from_module,
    rdb5c_reference,
)
from esr_tpu_torch.ops.fused import upsample2x_conv3x3, upsample2x_conv3x3_reference
from esr_tpu_torch.options import parse
from esr_tpu_torch.scripts.serve import make_server

REPO = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA H100 datasheet): bf16 tensor
# cores and HBM3. Bounds are stated against these whatever the power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

F32_TOL = 1e-4  # f32 kernel vs f32 plain: up to 9*192 terms summed in another order
CEM_TOL = 1e-5  # max |H(out) - lr|: the projection is exact up to f32 rounding
PSNR_MARGIN_DB = 1.0  # bf16 kernel path may trail the bf16 plain path by this much

NF, GC, NB, SCALE, NZ = 64, 32, 23, 4, 1
B, LR = 16, 128  # the bench shape of the JAX package's bench.py

FAILURES: list[str] = []


def check(cond: bool, what: str) -> None:
    print(("ok    " if cond else "FAIL  ") + what, flush=True)
    if not cond:
        FAILURES.append(what)


def cuda_ms(fn, reps: int = 10, warmup: int = 2, windows: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``reps`` back-to-back calls (so the host's enqueue runs ahead of the
    card), median over ``windows`` such runs; L2 warm."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def conv_bf16_band(ref: torch.Tensor, plain_err: float) -> float:
    """Tolerance of a bf16 conv kernel against the f32 plain version on the
    same (bf16-rounded) inputs: twice the bf16 plain version's own error, or
    two bf16 ulps (2^-6 relative) of the largest output, whichever is larger.
    A conv has no skip path, so its largest output is its own work."""
    return max(2.0 * plain_err, 2.0**-6 * ref.abs().max().item())


def gen(shape, seed: int, scale: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()


def rdb_params(seed: int) -> dict:
    """RDB weights at Kaiming scale (gain sqrt 2), not the generator's x0.1:
    the residual branch 0.2 * x5 then has a std near 0.3 beside x's 1, so a
    band on the block's output sees what the convs compute, not only x."""
    out = {}
    for k in range(1, 6):
        cin, cout = NF + (k - 1) * GC, NF if k == 5 else GC
        out[f"w{k}"] = gen((3, 3, cin, cout), seed + k, math.sqrt(2.0 / (9 * cin)))
        out[f"b{k}"] = gen((cout,), seed + 10 + k, 0.01)
    return out


def rdb_faults(x: torch.Tensor, p: dict) -> dict[str, torch.Tensor]:
    """The f32 plain RDB with the faults a band must be able to see."""
    w5 = p["w5"].clone()
    w5[:, :, NF:] = 0  # conv5 reads x only
    no_rezero = rdb5c_reference(F.pad(x, (0, 0, 5, 5, 5, 5)), p)[:, 5:-5, 5:-5]
    return {"drops x1..x4": rdb5c_reference(x, dict(p, w5=w5)),
            "skips the image-edge zeroing": no_rezero, "returns x": x}


def convT_weight(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO 3x3 kernel -> the (Cin, Cout, 4, 4) weight of
    ``F.conv_transpose2d(x, ., stride=2, padding=1)``, which computes
    ``conv3x3(SAME)(nearest_2x(x))``: transposed tap k of output parity a
    reads x[m + (a + 1 - k) / 2], so the 3 taps fold onto 4 as below."""
    fold = kernel.new_tensor([[0, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0]])
    return torch.einsum("ka,lb,abio->iokl", fold, fold, kernel)


def conv_row(per_site: list[dict], **keys) -> dict:
    """A conv mode's row of the kernels line: times and bounds summed over its
    sites, each site listed; bound_by is what bounds the larger share."""
    total = {k: sum(site[k] for site in per_site) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = sum(site["bound_ms"] for site in per_site if site["bound_by"] == "operations")
    for site in per_site:
        print(f"  {site['site']:<11s} {site['shape']:<28s} kernel {site['ms']:.4f} ms, library "
              f"{site['library_ms']:.4f} ms, plain {site['plain_ms']:.4f} ms, bound {site['bound_ms']:.4f} ms "
              f"({site['bound_by']})", flush=True)
    return {"name": keys.pop("name"), "route": "cuda", **keys, **total,
            "bound_by": "operations" if by_ops >= total["bound_ms"] - by_ops else "bytes", "sites": per_site}


def rdb5c_edge_checks(p: dict) -> None:
    """The bf16 RDB kernel where its TMA window and tile walk can go wrong:
    ragged grids, batch 1, an image smaller than one tile, H and W that are
    not multiples of the tile; weights built once, as the forward runs it.
    Each within the bf16 band of the f32 plain version on the same bf16
    inputs, counted as one launch."""
    kw = rdb5c_kernel_weights(p, torch.bfloat16, torch.device("cuda"))
    for i, shape in enumerate(((2, 37, 53), (1, 16, 40), (1, 5, 7), (1, 33, 18))):
        xb = gen(shape + (NF,), 90 + i).bfloat16()
        ref = rdb5c_reference(xb.float(), p)
        tol = 2.0 * max_err(rdb5c_reference(xb, p), ref)
        before = rdb_conv.LAUNCHES.count
        got = rdb5c_launch(xb, kw)
        ran = rdb_conv.LAUNCHES.count == before + 1
        e = max_err(got, ref) if got.shape == ref.shape else math.inf
        check(ran and e <= tol, f"rdb5c bf16 tensor cores {shape}: max err {e:.3g} <= {tol:.3g}, "
              f"one launch counted {ran}")


def conv_edge_checks() -> None:
    """The bf16 conv kernel in both modes where TMA and the persistent tiling
    can go wrong: ragged grids, batch 1, conv_first's Cin 4 (plain window
    loads, no TMA), conv_last's Cout 3 (pixels as M, wgmma n8, 2-byte
    stores), both act values; each within the bf16 band and counted as one
    launch."""
    for shape in ((2, 37, 53), (1, 16, 40)):
        for cin, cout in ((3 + NZ, NF), (NF, NF), (NF, 3)):
            x = gen(shape + (cin,), 80 + cin + cout).bfloat16()
            w = gen((3, 3, cin, cout), 81, math.sqrt(2.0 / (9 * cin)))
            bias = gen((cout,), 82, 0.01)
            for act in (False, True):
                for ksize, counter, plain in ((3, kpack_conv.LAUNCHES, conv3x3_reference),
                                              (2, kpack_conv.LAUNCHES_UP, upsample2x_conv3x3_reference)):
                    kw = conv_kernel_weights(w, bias, torch.bfloat16, x.device, ksize)
                    before = counter.count
                    got = conv_launch(x, kw, act)
                    ran = counter.count == before + 1
                    ref = plain(x.float(), w, bias, act)
                    tol = conv_bf16_band(ref, max_err(plain(x, w, bias, act), ref))
                    e = max_err(got, ref) if got.shape == ref.shape else math.inf
                    check(ran and e <= tol, f"conv bf16 {ksize}x{ksize} mode {shape} {cin}->{cout} act={act}: "
                          f"max err {e:.3g} <= {tol:.3g}, one launch counted {ran}")


# -- phase 1 -------------------------------------------------------------------


def phase_environment() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} capability {cap} "
          f"card {smi}", flush=True)
    check(cap == (9, 0), f"compute capability {cap} is Hopper (9, 0)")
    return {"card": smi, "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


# -- phase 2 -------------------------------------------------------------------


def phase_build() -> None:
    secs = lib.build_all()
    for name in lib._SIGNATURES:
        lib.load(name)
        report = lib._lib_path(name).with_suffix(".log").read_text().splitlines()
        usage = [ln.strip() for ln in report if "registers" in ln or "spill" in ln or "C75" in ln]
        print(f"ptxas {name}: " + " | ".join(usage), flush=True)
        if name == "rdb5c":  # the main path's RDB kernel: wgmma pipelined, nothing in local memory
            tc = [i for i, ln in enumerate(report) if "Function properties" in ln and "rdb5c_tc_kernel" in ln]
            spills = report[tc[0] + 1].strip() if tc else "no report"
            serialized = [ln for ln in report if "are serialized" in ln and "rdb5c_tc_kernel" in ln]
            check(spills.startswith("0 bytes stack frame, 0 bytes spill stores") and not serialized,
                  f"ptxas rdb5c_tc_kernel: {spills}; wgmma serialization warnings: {len(serialized)}")
    print(f"build: {secs:.1f} s (nvcc, all sources in parallel)", flush=True)


# -- phase 3 -------------------------------------------------------------------


@torch.no_grad()
def phase_kernels() -> list[dict]:
    """Each kernel against its plain version. The main path runs the bf16
    tensor-core kernels (both wgmma); the f32 checks
    run the f32 SIMT kernels of the same sources, which only f32 callers
    reach. Each row's ``max_abs_err`` is the bf16 kernel's,
    ``f32_simt_max_abs_err`` the f32 one's."""
    rows = []
    print(f"tolerances: f32 SIMT kernels vs f32 plain {F32_TOL} (up to 9 x 192 products summed in "
          "another order than cuDNN's, TF32 off). bf16 tensor-core kernels vs f32 plain on the same "
          "bf16 inputs: rdb5c within twice the bf16 plain version's own error, at weights where the "
          "residual branch is a third of the output, and the band must be a quarter or less of what "
          "a faulty kernel would be off by; the convs within twice the bf16 plain version's error "
          "or two bf16 ulps of the largest output", flush=True)

    # K1/K2: the fused RDB, through both wrappers
    p = rdb_params(100)
    xr, xm = gen((2, 37, 53, NF), 1), gen((B, LR, LR, NF), 2)
    f32_errs = []
    for label, x, fn in (
        ("tiled 8x12 ragged grid", xr, lambda t: fused_rdb5c_tiled(t, p, strip=8, wtile=12)),
        ("fused_rdb5c", xr, lambda t: fused_rdb5c(t, p)),
        ("fused_rdb5c", xm, lambda t: fused_rdb5c(t, p)),
    ):
        label = f"{label} {tuple(x.shape)}"
        e = max_err(fn(x), rdb5c_reference(x, p))
        check(e <= F32_TOL, f"rdb5c f32 SIMT {label}: max err {e:.3g} <= {F32_TOL}")
        f32_errs.append(e)
    bf16_errs = []
    for x, calls in (
        (xr, {"tiled 16x16": lambda t: fused_rdb5c_tiled(t, p, strip=16, wtile=16),
              "fused_rdb5c 16x16": lambda t: fused_rdb5c(t, p)}),
        (xm, {"fused_rdb5c 16x16": lambda t: fused_rdb5c(t, p)}),
    ):
        label = str(tuple(x.shape))
        xb = x.bfloat16()
        ref_b = rdb5c_reference(xb.float(), p)
        plain_err = max_err(rdb5c_reference(xb, p), ref_b)
        tol = 2.0 * plain_err
        for fault, y in rdb_faults(xb.float(), p).items():
            off = max_err(y, ref_b)
            check(4.0 * tol <= off, f"rdb5c bf16 band {tol:.3g} at {label} sees a kernel that {fault} "
                  f"(off by {off:.3g})")
        for name, fn in calls.items():
            e = max_err(fn(xb), ref_b)
            check(e <= tol, f"rdb5c bf16 tensor cores {name} {label} vs f32 plain: max err {e:.3g} "
                  f"<= {tol:.3g} (bf16 plain version's err {plain_err:.3g})")
            bf16_errs.append(e)
    xb = xm.bfloat16()
    kw5 = rdb5c_kernel_weights(p, torch.bfloat16, xb.device)  # built once, as the forward does
    try:
        fused_rdb5c_tiled(xr.bfloat16(), p, strip=12, wtile=8)
        refused = False
    except ValueError:
        refused = True
    check(refused, "rdb5c bf16 refuses a tile other than 16x16 (ValueError)")
    rdb5c_edge_checks(p)
    flops = 2 * 9 * (sum((NF + k * GC) * GC for k in range(4)) + (NF + 4 * GC) * NF) * B * LR * LR
    nbytes = 2 * xb.numel() * 2 + sum(v.numel() * (2 if k[0] == "w" else 4) for k, v in p.items())
    b_ms, b_by = bound(flops, nbytes)
    rows.append({
        "name": "rdb5c", "route": "cuda",
        "source": "esr_tpu_torch/ops/cuda/csrc/rdb5c.cuh (rdb5c_tc_kernel; f32: rdb5c_kernel)",
        "replaces": "esr_tpu/ops/pallas/rdb_conv.py:163 (fused_rdb5c), :215 (fused_rdb5c_tiled)",
        "tpu_kernel": "K1 fused_rdb5c + K2 fused_rdb5c_tiled",
        "shape": "x (16,128,128,64) bf16, nf 64 gc 32",
        "max_abs_err": max(bf16_errs), "f32_simt_max_abs_err": max(f32_errs),
        "ms": cuda_ms(lambda: rdb5c_launch(xb, kw5)),
        "plain_ms": cuda_ms(lambda: rdb5c_reference(xb, p)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "launches_per_forward": 3 * NB,
    })

    # K3, 3x3 SAME mode: conv_first, trunk_conv, HRconv, conv_last. Kernel
    # times through conv_launch with the weight image built once, as the
    # forward runs it; the library call with its operands prepared outside
    # the timed call.
    hr = LR * SCALE
    sites = [("conv_first", LR, 3 + NZ, NF, False), ("trunk_conv", LR, NF, NF, False),
             ("HRconv", hr, NF, NF, True), ("conv_last", hr, NF, 3, False)]
    f32_errs, bf16_errs, per_site = [], [], []
    for i, (site, s, cin, cout, act) in enumerate(sites):
        x = gen((B, s, s, cin), 20 + i)
        w = gen((3, 3, cin, cout), 30 + i, math.sqrt(2.0 / (9 * cin)))
        bias = gen((cout,), 40 + i, 0.01)
        e = max_err(kpack_conv3x3(x, w, bias, act), conv3x3_reference(x, w, bias, act))
        check(e <= F32_TOL, f"conv3x3 f32 SIMT {site} {cin}->{cout} at {s}x{s}: max err {e:.3g} <= {F32_TOL}")
        f32_errs.append(e)
        xb = x.bfloat16()
        kw = conv_kernel_weights(w, bias, torch.bfloat16, xb.device)
        ref_b = conv3x3_reference(xb.float(), w, bias, act)
        plain_err = max_err(conv3x3_reference(xb, w, bias, act), ref_b)
        eb = max(max_err(kpack_conv3x3(xb, w, bias, act), ref_b), max_err(conv_launch(xb, kw, act), ref_b))
        tol = conv_bf16_band(ref_b, plain_err)
        check(eb <= tol, f"conv3x3 bf16 tensor cores {site}: max err {eb:.3g} <= {tol:.3g} "
              f"(plain {plain_err:.3g})")
        bf16_errs.append(eb)
        wb, xc, bb = w.permute(3, 2, 0, 1).bfloat16(), xb.permute(0, 3, 1, 2), bias.bfloat16()
        b_ms, b_by = bound(2 * 9 * cin * cout * B * s * s, 2 * B * s * s * (cin + cout) + 2 * w.numel())
        per_site.append({
            "site": site, "shape": f"B{B} {s}x{s} {cin}->{cout}" + (" lrelu" if act else ""),
            "ms": cuda_ms(lambda: conv_launch(xb, kw, act)),
            "plain_ms": cuda_ms(lambda: conv3x3_reference(xb, w, bias, act)),
            "library_ms": cuda_ms(lambda: F.conv2d(xc, wb, bb, padding=1)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    rows.append(conv_row(
        per_site, name="conv3x3", source="esr_tpu_torch/ops/cuda/csrc/conv3x3.cuh",
        replaces="esr_tpu/ops/pallas/kpack_conv.py:61 (kpack_conv3x3)", tpu_kernel="K3 kpack_conv3x3",
        shape="B16 bf16: conv_first 4->64 @128, trunk_conv 64->64 @128, HRconv 64->64 @512, "
              "conv_last 64->3 @512 (times summed over the four; library: F.conv2d, channels_last)",
        max_abs_err=max(bf16_errs), f32_simt_max_abs_err=max(f32_errs), launches_per_forward=4,
    ))

    # K3, 2x2 parity mode: the two fused nearest-2x upsample convs
    f32_errs, bf16_errs, per_site = [], [], []
    for i, s in enumerate((LR, 2 * LR)):
        x = gen((B, s, s, NF), 50 + i)
        w = gen((3, 3, NF, NF), 60 + i, math.sqrt(2.0 / (9 * NF)))
        bias = gen((NF,), 70 + i, 0.01)
        ref = conv3x3_reference(upsample_nearest(x, 2), w, bias, act=True)
        e = max_err(upsample2x_conv3x3(x, w, bias, act=True), ref)
        check(e <= F32_TOL, f"upsample2x_conv3x3 f32 SIMT at {s}->{2 * s} vs nearest-2x + F.conv2d: "
              f"max err {e:.3g} <= {F32_TOL}")
        f32_errs.append(e)
        xc = x.permute(0, 3, 1, 2)
        e = max_err(F.leaky_relu(F.conv_transpose2d(xc, convT_weight(w), bias, stride=2, padding=1), 0.2)
                    .permute(0, 2, 3, 1), ref)
        check(e <= F32_TOL, f"library call F.conv_transpose2d computes the same at {s}: max err {e:.3g}")
        xb = x.bfloat16()
        kw = conv_kernel_weights(w, bias, torch.bfloat16, xb.device, ksize=2)
        ref_b = conv3x3_reference(upsample_nearest(xb.float(), 2), w, bias, act=True)
        plain_err = max_err(upsample2x_conv3x3_reference(xb, w, bias, act=True), ref_b)
        eb = max(max_err(upsample2x_conv3x3(xb, w, bias, act=True), ref_b),
                 max_err(conv_launch(xb, kw, True), ref_b))
        tol = conv_bf16_band(ref_b, plain_err)
        check(eb <= tol, f"upsample2x_conv3x3 bf16 tensor cores at {s}: max err {eb:.3g} <= {tol:.3g} "
              f"(plain {plain_err:.3g})")
        bf16_errs.append(eb)
        w4b, xcb, bb = convT_weight(w).bfloat16(), xb.permute(0, 3, 1, 2), bias.bfloat16()
        b_ms, b_by = bound(2 * 16 * NF * NF * B * s * s, 2 * B * s * s * NF * 5 + 2 * 16 * NF * NF)
        per_site.append({
            "site": f"upconv{i + 1}", "shape": f"B{B} {s}->{2 * s} 64->64 lrelu",
            "ms": cuda_ms(lambda: conv_launch(xb, kw, True)),
            "plain_ms": cuda_ms(lambda: upsample2x_conv3x3_reference(xb, w, bias, act=True)),
            "library_ms": cuda_ms(lambda: F.conv_transpose2d(xcb, w4b, bb, stride=2, padding=1)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    rows.append(conv_row(
        per_site, name="upsample2x_conv3x3", source="esr_tpu_torch/ops/cuda/csrc/conv3x3.cuh",
        replaces="esr_tpu/ops/pallas/kpack_conv.py:61 (kpack_conv3x3, 2x2 window) "
                 "for esr_tpu/ops/fused.py:32 (upsample2x_conv3x3)",
        tpu_kernel="K3 kpack_conv3x3 (2x2 parity window)",
        shape="B16 bf16 64->64: 128->256 and 256->512 (times summed over the two; "
              "library: F.conv_transpose2d stride 2 with the folded 4x4 weight, channels_last)",
        max_abs_err=max(bf16_errs), f32_simt_max_abs_err=max(f32_errs), launches_per_forward=2,
    ))
    conv_edge_checks()
    return rows


# -- phase 4 -------------------------------------------------------------------


def plain_forward(g, lr: torch.Tensor, z: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """The generator's math on its own weights with every kernel replaced by
    its plain PyTorch version, computing in ``dtype``."""
    x = torch.cat([lr, z if z is not None else lr.new_zeros(lr.shape[:-1] + (NZ,))], -1).to(dtype)

    def conv(m, t):
        return conv3x3_reference(t, m.hwio(), m.bias, m.act)

    fea = conv(g.conv_first, x)
    trunk = fea
    for blk in g.RRDB_trunk:
        out = trunk
        for rdb in (blk.RDB1, blk.RDB2, blk.RDB3):
            out = rdb5c_reference(out, rdb5c_params_from_module(rdb))
        trunk = trunk + 0.2 * out
    fea = fea + conv(g.trunk_conv, trunk)
    for up in (g.upconv1, g.upconv2):
        fea = upsample2x_conv3x3_reference(fea, up.hwio(), up.bias, act=True)
    return conv(g.conv_last, conv(g.HRconv, fea)).float()


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR in dB with peak 1 (images in [0, 1])."""
    mse = torch.mean((a.float() - b.float()) ** 2).item()
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


COUNTERS = (rdb_conv.LAUNCHES, kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP)
EXPECTED_PER_FORWARD = {"rdb5c": 3 * NB, "conv3x3": 4, "upsample2x_conv3x3": 2}


@torch.no_grad()
def phase_requests() -> dict[str, int]:
    opt = {"network_G": {"which_model_G": "RRDB_net", "nf": NF, "nb": NB, "gc": GC,
                         "num_latent_channels": NZ}, "scale": SCALE, "bf16": True}
    g = define_G(opt, device="cuda", seed=0)
    cem = make_cem(CEMConf(scale=SCALE), device="cuda")
    fwd = make_eval_forward(g, cem)
    rng = np.random.default_rng(0)

    def lr_img(n, h, w):
        return torch.from_numpy(rng.random((n, h, w, 3), dtype=np.float32)).cuda()

    def z_draw(lr, seed):  # X-Z-Mode: random, X-Z-Seed: seed
        zr = np.random.default_rng(seed).uniform(-1, 1, lr.shape[:3] + (NZ,)).astype(np.float32)
        return torch.from_numpy(zr).cuda()

    lr96 = lr_img(1, 96, 80)
    lr4 = lr_img(4, 64, 64)
    requests = [
        ("LR 64x64, zeros Z", lr_img(1, 64, 64), None),
        ("LR 96x80, random Z seed 1", lr96, z_draw(lr96, 1)),
        ("LR 96x80, random Z seed 2", lr96, z_draw(lr96, 2)),
        ("batch 4 x LR 64x64, zeros Z", lr4, torch.zeros(4, 64, 64, NZ, device="cuda")),
    ]
    for c in COUNTERS:
        c.reset()
    answers = []
    for what, lr, z in requests:
        before = {c.name: c.count for c in COUNTERS}
        t0 = time.perf_counter()
        out = fwd(lr, z)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {c.name: c.count - before[c.name] for c in COUNTERS}
        n, h, w, _ = lr.shape
        check(tuple(out.shape) == (n, SCALE * h, SCALE * w, 3), f"{what}: answer shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{what}: every value finite")
        res = max_err(cem.downsample(out), lr)
        check(res <= CEM_TOL, f"{what}: CEM residual max|H(out) - lr| {res:.3g} <= {CEM_TOL}")
        check(counts == EXPECTED_PER_FORWARD, f"{what}: launches {counts} == {EXPECTED_PER_FORWARD}")
        ref32 = cem.project(plain_forward(g, lr, z, torch.float32), lr)
        plain16 = cem.project(plain_forward(g, lr, z, torch.bfloat16), lr)
        pk, pp = psnr(out, ref32), psnr(plain16, ref32)
        check(pk >= pp - PSNR_MARGIN_DB, f"{what}: PSNR vs f32 plain path: kernels {pk:.2f} dB, "
              f"bf16 plain {pp:.2f} dB (margin {PSNR_MARGIN_DB} dB); {secs * 1e3:.1f} ms")
        png = tensor2img(out[:1])
        check(png.dtype == np.uint8 and png.shape == (SCALE * h, SCALE * w, 3), f"{what}: uint8 answer {png.shape}")
        answers.append(out)
    d = max_err(answers[1], answers[2])
    check(d > 1e-3, f"two Z seeds give different answers (max diff {d:.3g})")
    totals = {c.name: c.count for c in COUNTERS}

    # f32 kernel path vs f32 plain path at nb=2
    opt32 = {"network_G": dict(opt["network_G"], nb=2), "scale": SCALE, "bf16": False}
    g32 = define_G(opt32, device="cuda", seed=1)
    fwd32 = make_eval_forward(g32, cem)
    lr = lr_img(2, 40, 36)
    z = z_draw(lr, 3)
    e = max_err(fwd32(lr, z), cem.project(plain_forward(g32, lr, z, torch.float32), lr))
    check(e <= F32_TOL, f"f32 kernel forward vs f32 plain forward (nb=2, 2x40x36): max err {e:.3g} <= {F32_TOL}")
    return totals


# -- phase 5 -------------------------------------------------------------------


@torch.no_grad()
def phase_timing(card: str, rows: list[dict]) -> None:
    opt = {"network_G": {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ},
           "scale": SCALE, "bf16": True}
    g = define_G(opt, device="cuda", seed=0)
    cem = make_cem(CEMConf(scale=SCALE), device="cuda")
    fwd = make_eval_forward(g, cem)
    lr = torch.rand(B, LR, LR, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    z = torch.zeros(B, LR, LR, NZ, device="cuda")
    plain = lambda: cem.project(plain_forward(g, lr, z, torch.bfloat16), lr)  # noqa: E731

    def layout_per_call(per_call: bool) -> None:
        """Build the kernels' weight layouts once, as make_eval_forward does,
        or drop them so that every kernel call rebuilds its own."""
        for m in g.modules():
            if hasattr(m, "prepare_kernel"):
                m.kernel_weights = None
        if not per_call:
            g.prepare_kernels()

    # plain, kernels, kernels with the weight layout built per call (x2),
    # kernels, plain: same card, same process
    t = {"plain": [], "kernels": [], "kernels, layout per call": []}
    for name in ("plain", "kernels", "kernels, layout per call", "kernels, layout per call", "kernels", "plain"):
        layout_per_call(name == "kernels, layout per call")
        t[name].append(cuda_ms(plain if name == "plain" else lambda: fwd(lr, z), reps=2, warmup=1, windows=3))
    hr_mp = B * (LR * SCALE) ** 2 / 1e6
    for name, ms in t.items():
        m = statistics.mean(ms)
        print(f"flagship forward B{B} LR{LR} x{SCALE} ({name}): {m:.2f} ms/forward "
              f"({', '.join(f'{v:.2f}' for v in ms)}), {hr_mp / (m / 1e3):.3f} HR MP/s on {card}", flush=True)
    print(f"kernel path / bf16 plain path: {statistics.mean(t['kernels']) / statistics.mean(t['plain']):.3f} "
          "of the time per forward", flush=True)

    # where the kernel path's time goes: device time by kernel over two forwards
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            fwd(lr, z)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile, 2 forwards (kernels): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%, idle {100 - 100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  x{e.count:<5d} {e.key[:90]}", flush=True)
    rdb = [e for e in kernels if "rdb5c" in e.key]
    rdb_ms = sum(e.self_device_time_total for e in rdb) / 1e3 / 2
    rdb_n = sum(e.count for e in rdb) // 2
    print(f"rdb5c (rdb5c_tc_kernel, {rdb_n} launches): {rdb_ms:.3f} ms of device time per forward, "
          f"{rdb_ms / max(rdb_n, 1):.4f} ms per launch, {100 * 2 * rdb_ms / busy_ms:.1f}% of device busy time",
          flush=True)
    conv = [e for e in kernels if "conv_tc_kernel" in e.key]
    conv_ms = sum(e.self_device_time_total for e in conv) / 1e3 / 2
    lib_ms = sum(r["library_ms"] for r in rows if r["name"] != "rdb5c")
    print(f"conv_tc_kernel (3x3 and 2x2 modes, {sum(e.count for e in conv) // 2} launches): "
          f"{conv_ms:.3f} ms of device time per forward; the library calls for the same six convs "
          f"(phase 3): {lib_ms:.3f} ms", flush=True)
    for e in sorted(conv, key=lambda e: e.key):
        print(f"  {e.self_device_time_total / 1e3 / 2:9.3f} ms/forward x{e.count // 2:<3d} {e.key[:90]}", flush=True)


# -- phases 6 and 7: the inference entry points --------------------------------

METRIC_TOL = {"psnr": 1e-3, "z_psnr_mean": 1e-3, "z_psnr_spread": 2e-3, "ssim": 1e-5, "z_ssim_mean": 1e-5}
# batched vs serial: the same kernels per image, the CEM matmuls at another
# batch size; PSNR within 1e-3 dB, SSIM 1e-5, Z diversity 1e-3 relative


def counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before; returns
    (its result, the launches by kernel, wall seconds to a synchronised end)."""
    for c in COUNTERS:
        c.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {c.name: c.count for c in COUNTERS}, time.perf_counter() - t0


def check_launches(what: str, counts: dict, forwards: int, calls_per_forward: int = 1) -> None:
    want = {k: v * forwards * calls_per_forward for k, v in EXPECTED_PER_FORWARD.items()}
    check(counts == want and all(counts.values()), f"{what}: launches {counts} == {want} "
          f"({forwards} forwards x {calls_per_forward} generator call(s) x {EXPECTED_PER_FORWARD})")


def flagship_options(tmp: Path, pth: str, name: str, datasets: dict, **extra) -> dict:
    """The port's copy of test_explorable.json (flagship RRDB, nz 1, CEM; bf16
    kernels by default), pointed at ``tmp``, the seeded weights and
    ``datasets``."""
    opt = json.loads((REPO / "esr_tpu_torch" / "options" / "test" / "test_explorable.json").read_text())
    opt.update(name=name, datasets=datasets, **extra)
    opt["path"] = {"root": str(tmp), "pretrain_model_G": pth}
    return opt


def run_cli(tmp: Path, opt: dict, *flags: str):
    path = tmp / f"{opt['name']}.json"
    path.write_text(json.dumps(opt))
    return counted(lambda: eval_cli.main(["-opt", str(path), *flags]))


@torch.no_grad()
def phase_eval(tmp: Path, pth: str) -> dict[str, dict]:
    """The eval CLI at the flagship width; returns the launches by path."""
    hr_dir, big_dir = tmp / "hr", tmp / "hr_div2k"
    t0 = time.perf_counter()
    to_u8 = lambda a: (a * 255.0).round().astype(np.uint8)  # noqa: E731
    big = to_u8(SyntheticDataset({"phase": "test", "image_size": 2040})._make_image(5)[:, :1356])
    save_img(big, str(hr_dir / "div2k.png"))
    save_img(big, str(big_dir / "div2k.png"))
    save_img(to_u8(SyntheticDataset({"phase": "test", "image_size": 406})._make_image(6)[:, :301]),
             str(hr_dir / "ragged.png"))
    print(f"eval: wrote HR PNGs 2040x1356 and 406x301 with the port's codec in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    datasets = {"test_1": {"name": "synthetic", "mode": "SYNTHETIC", "n_images": 4, "image_size": 512},
                "test_2": {"name": "folder", "mode": "LRHR", "dataroot_HR": str(hr_dir)}}
    common = {"num_random_Z": 2, "eval_pad_bucket": 32}
    n_draws, n_images = 3, 6
    launches = {}

    opt_serial = flagship_options(tmp, pth, "eval_serial", datasets, **common)
    serial, counts, secs_serial = run_cli(tmp, opt_serial, "--save_images")
    check_launches("eval CLI, serial", counts, n_images * n_draws)
    launches["eval_cli"] = counts
    batched, counts, secs_batched = run_cli(tmp, flagship_options(tmp, pth, "eval_batched", datasets,
                                                                   eval_batch=4, **common))
    check_launches("eval CLI, eval_batch 4 (synthetic: 1 batch of 4; folder: 2 shapes of 1)", counts, 3 * n_draws)
    launches["eval_cli_batched"] = counts
    for name in serial:
        s, b = serial[name], batched[name]
        check(sorted(s) == sorted(b), f"eval [{name}]: the same metrics serial and batched")
        for k, v in s.items():
            if k == "cem_residual":
                check(v <= CEM_TOL and b[k] <= CEM_TOL, f"eval [{name}]: CEM residual max over every draw "
                      f"{v:.3g} serial, {b[k]:.3g} batched <= {CEM_TOL}")
            else:
                tol = METRIC_TOL.get(k, 1e-3 * abs(v))
                check(abs(b.get(k, math.inf) - v) <= tol, f"eval [{name}] {k}: serial {v:.6f}, batched "
                      f"{b.get(k, math.nan):.6f} (tol {tol:.3g})")
    se, counts, secs_se = run_cli(tmp, flagship_options(
        tmp, pth, "eval_self_ensemble", {"test_1": {"name": "div2k", "mode": "LRHR", "dataroot_HR": str(big_dir)}},
        self_ensemble=True, num_random_Z=0))
    check_launches("eval CLI, self_ensemble on the DIV2K-sized image", counts, 1, calls_per_forward=2)
    check(se["div2k"]["cem_residual"] <= CEM_TOL, f"self-ensemble: CEM residual {se['div2k']['cem_residual']:.3g}")
    launches["eval_cli_self_ensemble"] = counts
    print(f"eval CLI wall per image per draw (decode, forward, scoring on the host, PNG writes): serial "
          f"{secs_serial / (n_images * n_draws) * 1e3:.1f} ms, batched {secs_batched / (n_images * n_draws) * 1e3:.1f} ms"
          f"; self-ensemble CLI run (1 DIV2K-sized image) {secs_se:.2f} s", flush=True)
    for name in serial:
        print(f"eval [{name}] serial: " + json.dumps(serial[name]), flush=True)

    # the saved PNGs and the DIV2K-sized image against the plain paths, on the
    # model the CLI builds
    opt = parse(opt_serial, is_train=False)
    model = create_model(opt)
    folder = create_dataset(opt["datasets"]["test_2"])
    out_dir = tmp / "results" / "eval_serial" / "folder"
    for idx, name in enumerate(("div2k", "ragged")):
        lr_p, orig = eval_cli._pad_to_bucket(folder[idx]["LR"], 32)
        for zi in (0, 2):
            model.feed_data({"LR": lr_p})
            model.test(z=eval_cli._eval_z_draw(idx, zi - 1, lr_p.shape[:2], NZ) if zi else None)
            want = eval_cli._sr_image(model.get_visuals_uint8()["SR"], orig, SCALE)
            saved = read_img_uint8(str(out_dir / f"{name}{'_z%d' % zi if zi else ''}.png"))
            check(saved.shape == want.shape and bool((saved == want).all()),
                  f"eval: saved {name} draw {zi} PNG {saved.shape} decodes to the SR uint8 (LR {lr_p.shape[:2]})")
    g, cem, fwd = model.g_module, model.cem, model._forward
    lr = torch.from_numpy(folder[0]["LR"])[None].cuda()
    z = torch.from_numpy(eval_cli._eval_z_draw(0, 0, lr.shape[1:3], NZ))[None].cuda()
    out, counts, _ = counted(lambda: fwd(lr, z))
    check_launches(f"DIV2K-sized forward, LR {tuple(lr.shape[1:3])} (odd width)", counts, 1)
    res = max_err(cem.downsample(out), lr)
    ref32 = cem.project(plain_forward(g, lr, z, torch.float32), lr)
    plain16 = cem.project(plain_forward(g, lr, z, torch.bfloat16), lr)
    pk, pp = psnr(out, ref32), psnr(plain16, ref32)
    check(res <= CEM_TOL and pk >= pp - PSNR_MARGIN_DB, f"DIV2K-sized image: CEM residual {res:.3g}; PSNR vs f32 "
          f"plain path: kernels {pk:.2f} dB, bf16 plain {pp:.2f} dB (margin {PSNR_MARGIN_DB} dB)")
    del ref32, plain16

    # device time of the forward (CEM included) per image per draw
    rng = np.random.default_rng(1)

    def timed(n, h, w, f=fwd, **kw):
        x = torch.from_numpy(rng.random((n, h, w, 3), dtype=np.float32)).cuda()
        zz = torch.zeros(n, h, w, NZ, device="cuda")
        return cuda_ms(lambda: f(x, zz), **kw) / n

    kw = {"reps": 2, "warmup": 1, "windows": 3}
    t_syn, t_syn4 = timed(1, 128, 128, **kw), timed(4, 128, 128, **kw)
    t_big, t_rag = timed(1, 512, 352, **kw), timed(1, 128, 96, **kw)
    t_se = timed(1, 510, 339, f=make_eval_forward(g, cem, self_ensemble=True), reps=1, warmup=1, windows=3)
    t_big_raw = timed(1, 510, 339, **kw)
    print(f"eval forward device ms per image per draw (CEM included): serial LR 128x128 {t_syn:.2f}, "
          f"batched 4 x 128x128 {t_syn4:.2f}; DIV2K-sized bucket 512x352 {t_big:.2f}, unpadded 510x339 "
          f"{t_big_raw:.2f}; ragged bucket 128x96 {t_rag:.2f}; self-ensemble 510x339 {t_se:.2f} "
          f"({t_se / t_big_raw:.2f}x the plain forward)", flush=True)
    cem_new = make_cem(CEMConf(scale=SCALE))
    t0 = time.perf_counter()
    for n in (510, 339):
        cem_new._axis_matrices(n)
    torch.cuda.synchronize()
    print(f"CEM axis matrices for a new LR shape 510x339 (host f64, once per shape): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    return launches


def post_sr(url: str, body: bytes, headers: dict | None = None) -> tuple[int, bytes]:
    req = urllib.request.Request(f"{url}/sr", data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@torch.no_grad()
def phase_serve(tmp: Path, pth: str) -> dict[str, int]:
    """Export, serve over HTTP, answer requests; returns the launches of the
    requests."""
    opt = parse(flagship_options(tmp, pth, "serve", {}), is_train=False)
    model = create_model(opt)
    art = tmp / "artifact"
    buckets = [(1, 64, 64), (1, 128, 128), (1, 96, 96)]
    t0 = time.perf_counter()
    manifest = export_servable(model, buckets, str(art))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = make_server(str(art), "127.0.0.1", 0)  # loads, builds layouts, one forward per bucket
    load_s = time.perf_counter() - t0
    print(f"serve: export {export_s:.2f} s ({(art / 'G.pth').stat().st_size / 2**20:.1f} MiB G.pth), server "
          f"load + one forward per bucket {load_s:.2f} s", flush=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    sv, live = server.servable, make_eval_forward(model.g_module, model.cem)
    totals = {c.name: 0 for c in COUNTERS}
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            check(r.status == 200 and json.loads(r.read()) == manifest, "serve: GET /healthz returns the manifest")
        rng = np.random.default_rng(2)
        lr64 = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
        lr96 = (rng.random((96, 80, 3)) * 255).astype(np.uint8)
        requests = [("LR 64x64, zeros Z", lr64, None), ("LR 96x80, random Z seed 1", lr96, 1),
                    ("LR 96x80, random Z seed 1 again", lr96, 1), ("LR 96x80, random Z seed 2", lr96, 2)]
        answers = []
        for what, img, seed in requests:
            headers = {} if seed is None else {"X-Z-Mode": "random", "X-Z-Seed": str(seed)}
            request = png.encode(img)
            (code, body), counts, secs = counted(lambda: post_sr(url, request, headers))
            check(code == 200, f"serve {what}: HTTP {code}")
            check_launches(f"serve {what}", counts, 1)
            for k, v in counts.items():
                totals[k] += v
            sr = png.decode(body)
            h, w = img.shape[:2]
            lr = img.astype(np.float32) / 255.0
            z = None if seed is None else np.random.default_rng(seed).uniform(-1, 1, (h, w, NZ)).astype(np.float32)
            _, bh, bw = sv._bucket_for(1, h, w)
            pad = ((0, bh - h), (0, bw - w), (0, 0))
            lr_p = torch.from_numpy(np.pad(lr, pad, mode="edge"))[None].cuda()
            z_p = torch.from_numpy(np.pad(z if z is not None else np.zeros((h, w, NZ), np.float32), pad,
                                          mode="edge"))[None].cuda()
            out = live(lr_p, z_p)
            res = max_err(model.cem.downsample(out), lr_p)
            want_live = tensor2img(out[:, : SCALE * h, : SCALE * w])
            want_sv = tensor2img(sv.sr(lr, z)[:1])
            check(sr.shape == (SCALE * h, SCALE * w, 3) and bool((sr == want_sv).all()) and bool((sr == want_live).all()),
                  f"serve {what}: answer {sr.shape} == live Servable == forward on the padded LR "
                  f"{(bh, bw)} cropped; CEM residual {res:.3g} <= {CEM_TOL}; {secs * 1e3:.1f} ms")
            check(res <= CEM_TOL, f"serve {what}: CEM residual {res:.3g} <= {CEM_TOL}")
            answers.append(body)
        check(answers[1] == answers[2] and answers[1] != answers[3] and answers[0] != answers[1],
              "serve: seed 1 twice gives the same bytes, seed 2 and zeros Z others")
        # where a request's time goes (LR 96x80, seed 1): the Servable call
        # (pad, upload, forward, download), the forward alone on the card,
        # the PNG codec; and the device's busy share over one whole request
        request, lr = png.encode(lr96), lr96.astype(np.float32) / 255.0
        z = np.random.default_rng(1).uniform(-1, 1, (96, 80, NZ)).astype(np.float32)
        lr_p = torch.from_numpy(np.pad(lr, ((0, 0), (0, 16), (0, 0)), mode="edge"))[None].cuda()
        z_p = torch.from_numpy(np.pad(z, ((0, 0), (0, 16), (0, 0)), mode="edge"))[None].cuda()
        host_ms = {"Servable.sr": lambda: sv.sr(lr, z), "PNG decode of the request": lambda: png.decode(request),
                   "tensor2img + PNG encode of the answer": lambda: png.encode(tensor2img(sv.sr(lr, z)[:1]))}
        parts = {}
        for name, fn in host_ms.items():
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            parts[name] = statistics.median(times)
        parts["tensor2img + PNG encode of the answer"] -= parts["Servable.sr"]
        fwd_ms = cuda_ms(lambda: sv.forward(lr_p, z_p), reps=5, warmup=1, windows=3)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            post_sr(url, request, {"X-Z-Mode": "random", "X-Z-Seed": "1"})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print("serve request LR 96x80 (bucket 96x96), host ms (median of 5): " +
              ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f"; forward on the card {fwd_ms:.2f} ms "
              f"(CUDA events, CEM included); one request under the profiler: wall {wall_ms:.2f} ms, device "
              f"busy {busy_ms:.2f} ms (idle {100 - 100 * busy_ms / wall_ms:.1f}%)", flush=True)
        code, msg = post_sr(url, b"junk, not an image")
        check(code == 400, f"serve junk body: HTTP {code} ({msg[:60]!r})")
        code, msg = post_sr(url, png.encode((rng.random((200, 200, 3)) * 255).astype(np.uint8)))
        check(code == 400 and b"no exported bucket" in msg, f"serve LR 200x200 (no bucket fits): HTTP {code}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "serve: server thread stopped")
    return totals


def main() -> int:
    env = phase_environment()
    phase_build()
    rows = phase_kernels()
    by_path = {"forward": phase_requests()}
    phase_timing(env["card"], rows)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        pth = str(tmp / "G.pth")
        opt = {"network_G": {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ}, "scale": SCALE}
        torch.save(define_G(opt, device="cuda", seed=0).state_dict(), pth)
        by_path.update(phase_eval(tmp, pth))
        by_path["serve"] = phase_serve(tmp, pth)
    for r in rows:
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        check(all(r["launches_by_path"].values()), f"{r['name']} launched on every path: {r['launches_by_path']}")
    print(json.dumps({"kernels": rows, "card": env["card"]}), flush=True)
    print(env["card"], flush=True)
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed:", *FAILURES, sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["kind"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
