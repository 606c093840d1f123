"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: torch / CUDA versions, compute capability, card name and
   power limit; TF32 off for every f32 comparison;
2. build the hand-written CUDA kernels (nvcc, sm_90a) from the checkout
   (ptxas: no spills in the 3 ``rdb5c_tc_kernel`` instances, the 18
   ``conv_tc_kernel`` and the 8 ``conv_f32_kernel`` instances, no wgmma
   serialization; the main RDB instance's ptxas line equal to the one it had
   before the other widths became instances);
3. hold each kernel against its plain PyTorch version on the card, at the
   flagship widths and main-path shapes: the bf16 tensor-core kernels the
   main path runs (with a band shown to see a faulty RDB kernel), the RDB
   kernel on ragged grids, batch 1 and an image smaller than a tile (and a
   bf16 tile other than 16 x 16, a schedule hint), the conv kernel on ragged
   grids, batch 1, Cin 4 and Cout 3 in both modes, the f32 route
   (``conv_f32_kernel``: every f32 conv site and the f32 RDB as five of its
   launches, timed at the flagship shapes beside the f32 bound, plain and
   library, and a Cin 256 conv), the bf16 convs wider than 64 channels on the
   tensor-core conv kernel (128 -> 128 and 128 -> 3 in both modes, 64 -> 96
   and 64 -> 576 on a ragged grid; B16 x 128^2 128 -> 128 in both modes) and
   the bf16 RDB at the other widths on the RDB kernel's other instances (nf
   8 / gc 4 and 16 / 8 on a ragged grid; 16 / 8, 32 / 16 and 128 / 64 at
   B16 x 128^2), each timed beside bound and plain;
   time each kernel with its weight layout built once (as the forward runs
   it), its plain version and the library call with CUDA events, per conv
   site (one ``{"kernels": [...]}`` JSON line);
4. answer requests through the CEM-wrapped flagship forward
   (RRDBNet nf=64 nb=23 gc=32 x4 nz=1, bf16 kernels, seeded Kaiming weights):
   shape, finiteness, CEM residual, Z diversity, launch counts, PSNR against
   the f32 plain path beside the bf16 plain path's; plus an f32 kernel-path
   forward against the f32 plain path at nb=2;
5. time the flagship forward at B16 x LR 128: kernel path, kernel path with
   the weight layout rebuilt in every call, and bf16 plain path; profile
   two kernel-path forwards (device time by kernel, busy share, the RDB
   kernel's time per forward, the conv kernel's beside the library calls');
   then the f32 flagship forward (``"bf16": false``, the f32 route's path)
   against the f32 plain path in turns: launches per forward on the f32
   counters and of ``conv_f32_kernel`` itself, CEM residual, max error
   within 1e-4 of the f32 plain path (a band the plain path with TF32 on
   misses), ms per forward, ``conv_f32_kernel``'s device time in it; and the
   eval forward as one CUDA graph per input shape (``EvalForward``) against
   the same forward eagerly, cuDNN deterministic, at B16 x LR 128, the
   serving buckets (1x128x128 also the explorer's render), B2 x LR 64 and a
   request's 96x80: bit for bit on the capture call and two replays, 69 / 4
   / 2 launches a replay, capture seconds and pool growth, a replay's trace
   (the eager forward's kernel events from one graph launch), ms of the
   graph, the eager kernel path and the bf16 plain path as a graph in turns
   (also at B16 x LR 128 above), the answer's copy, and a planted fault (a
   forward that keeps its graphs after new weights' layouts are built
   answers with the old weights; the layout generation check catches it);
   and the CEM-wrapped generator at nb 23 and the RDB kernel's other
   instances' widths, nf 32 / gc 16 at B16 x LR 128 and nf 128 / gc 64 at
   B4: 69 / 4 / 2 launches, CEM residual, PSNR against the f32 plain path
   within phase 10(f)'s band;
6. the eval CLI (``esr_tpu_torch.test.main``) at the flagship width on the
   weights of ``define_G(seed=0)`` loaded back from a ``.pth``: a SYNTHETIC
   set (4 images, HR 512) and a folder of PNGs written by the port's codec
   (a DIV2K-sized HR 2040x1356, LR 510x339, and a ragged HR 406x301:
   modcrop, then ``eval_pad_bucket`` 32), two Z draws; serially, with
   ``eval_batch`` 4, and the DIV2K-sized image with ``self_ensemble``:
   launches per forward, CEM residual of every draw, batched == serial, the
   saved PNGs == the SR uint8, the DIV2K-sized image's PSNR against the f32
   plain path beside the bf16 plain path's, ms per image per draw; a forward
   graph per padded shape (capture seconds, pool growth);
7. serving: export buckets 1x64x64, 1x128x128, 1x96x96, start the HTTP
   server in a thread, GET /healthz, POST /sr (zeros Z, seeded random Z
   twice and another seed, a junk body, an image too large): each answer
   equal to the live Servable's and to the eager forward on the padded LR
   cropped back, the Servable's graph (one per bucket, captured by
   make_server's warm-up) bit for bit against the eager forward, launches
   and latency per request and its parts (the forward as a graph and
   eagerly), export time;
8. training: the train CLI (``esr_tpu_torch.train.main``) on the port's
   copy of train_explorable_SR.json at full width (G nf 64 nb 23 gc 32 x4
   with Z and CEM, D nf 64 with BatchNorm, VGG19 conv5_4 loss, B16 x HR
   128, bf16): 6 steps on the SYNTHETIC train set with a checkpoint at 3
   and validation on one PNG written by the port's codec; 3 steps then
   ``--auto_resume`` to 6 equal to the straight run; the SR trainer
   (train_RRDB_PSNR.json) for 2 steps; launches per G forward (the
   backward launches none); each kernel's autograd Function at the shapes
   the train step gives it, its output and its x, w, b gradients against
   the plain version in phase 3's bands; on one fixed batch and Z, G's
   gradients through the kernels against the bf16 and f32 plain paths (a
   band shown to fail a step whose RDB kernel returns its input or whose
   conv pads with edge pixels) and the CEM residual of the step's own fake;
   ms per GAN step, steps/s, peak memory and the device's idle share (of
   the unprofiled step) of the kernel path beside the bf16 plain autograd
   path (in turns), where a step's time goes, and the host time of the
   per-call weight layouts;
9. exploration: the editor's session as the explore CLI builds it
   (``build_session_from_opt``: G from the seed-0 ``.pth``, CEM, a seed-0 D
   from its own ``.pth``) on an LR 128 x 128 PNG; a 40 x 40 LR selection
   (bucket 64, crop 256 HR) and one click of each tool at 32 steps a round
   (the session's 64, halved for time) (imprint adaptive, variance +/-, brightness, smooth, periodicity,
   histogram, realism, alternatives k=2 with one applied), then smooth with
   no selection (the whole image): each click's loss goes down (or its
   adaptive report names its stop), CEM residual, undo restores the SR bit
   for bit, no layout built; launches per G call over the clicks (the SR
   renders counted at the session's render forward, a CUDA graph of the
   image's shape: bit for bit against the session's forward eagerly), per
   Z step forward and backward (none) by hand; dloss/dZ through the kernels against
   the bf16 and f32 plain paths (a band shown to fail an RDB kernel that
   returns its input); ms per Z step beside the bf16 plain autograd path (in
   turns), per click, the device's idle share and host time per step;
10. blind SR and the generator variants: (a) CEM's fft and filter modes in
   f32 on B4 x LR 128 (HR 512) under the anisotropic Gaussian and the
   MATLAB-bicubic 2-D kernel with cuDNN's TF32 default on: residual, H
   against f64, adjointness, fft == matmul for bicubic, the filter residual
   at support 33, ms per ``project`` at B16; (b) KernelGAN: the
   effective-kernel identity, the supervised probe (corr > 0.88; run twice,
   the same kernel bit for bit), the adversarial estimate through
   ``scripts.blind_bench`` (LR 96, 2000 iterations), the iteration as a
   CUDA graph against the eager loop bit for bit over 250 iterations for
   both steps (cuDNN deterministic), ms per iteration of both in turns and
   a graphed chunk's device idle share; (c) the ``estimate_kernel`` script at 200
   iterations; (d) blind eval through
   ``test.main --estimate_kernel 200`` at the flagship width on two 1/f
   images and their Gaussian LR, beside the run without the flag, and with
   G's output zeroed, the estimator returning the true kernel against no
   flag (true-operator residuals; the CEM residual under an estimate is
   held to 1e-5 x sum|k|); (e) the explorer's session with
   ``estimate_kernel_iters`` 200 and one 64-step click; (f)
   ``latent_input='all_layers'`` at the flagship width, its 1x1 projections
   scaled to unit gain (forward at B16 x LR 128 with PSNR and launches, G's
   gradient band, two GAN steps)
   and SRResNet nf 64 nb 16 (forward, 38 tensor-core conv launches, its
   64 -> 256 ``upconv``s no slower than ``F.conv2d`` beside them, two
   SR-trainer steps).
11. the parallel axes, 2 ranks sharing the one card over gloo (spawned, a
   file store; NCCL needs a GPU per rank), seeded flagship weights, bf16,
   CEM matmul: (a) ``eval_spatial: 2`` at halo 32 and 16, B16 x LR 128
   (raw G rows a halo from the seam against the whole-image kernel forward
   bit for bit, CEM residual, PSNR against f32 plain); (b) ``eval_tp: 2``
   (PSNR; 0 / 349 / 2 launches a rank); (c) ``eval_pp: 2`` at nb 24, 8
   microbatches (the single-rank forward bit for bit); (d) ``dist_eval``
   over phase 6's SYNTHETIC set in the ranks and under ``python -m
   torch.distributed.run --nproc_per_node 2 -m esr_tpu_torch.test`` (the
   one-rank batched metrics; rank 0 alone reports and writes); (e) a
   ``dist`` GAN step, 2 x B8 against one process at B16, and (f) one of
   ``train_spatial``, ``train_tp`` and ``train_pp`` (nb 24): losses and G's
   gradients within phase 8's bands of one process's, G and D bit-identical
   on both ranks, each band shown to fail a planted fault (a TP backward
   scaled by T, a halo of 0, a dropped microbatch); (g) ``python -m
   esr_tpu_torch.parallel.multihost``, 2 processes against 1. Every rank
   reports its launches; the ms of each path is printed as that of 2 ranks
   on one card, not a scaling number.
12. the scripts, the profiler, the probes and the port's entry point:
   ``graft_entry.entry()``'s forward (B2 x LR 64: 69 / 4 / 2 launches, CEM
   residual); ``utils/profiler``'s ``StepTimer`` and a ``trace`` of two
   forwards in regions (138 ``rdb5c_tc_kernel`` events launched in them,
   by correlation id, in its Chrome trace, after a forward outside them; device ms
   by kernel, the host's split between CUDA launch calls, waits and aten
   ops' CPU time, also for one Z-search click); ``scripts.explore_bench``
   (one region, 2 repeat clicks, 32 steps, no adaptive imprint);
   ``scripts.ensemble_bench --n 2``; ``scripts.precision_ladder`` (bf16
   kernels' PSNR against the f32 plain oracle within 1 dB of the bf16 plain
   path's); ``scripts.parity_eval`` (f32, TF32 off) on the seed-0 ``.pth``
   in the reference's old key layout over two 1/f PNGs, the PSNR of the
   new layout's; ``scripts.quickstart --niter 4``; the int8 / FP8 probe at
   one conv shape and the 8192^3 matmul; the RDB kernel under tile hints at
   the DIV2K eval shape (``ops/cuda/tiled_probe``).
13. many steps in one dispatch: the train steps and the Z step as CUDA
   graphs (``utils/graphs.py``) against the same steps eagerly, cuDNN
   deterministic, at full width (B16 x HR 128): (a) the GAN step
   (train_explorable_SR.json): a chunk of 4 (``optimize_parameters_chunk``,
   ``steps_per_dispatch`` 4) across an ``lr_steps`` milestone against 4
   eager steps (G, D, Adam moments and metrics bit for bit, or within phase
   8's bands), 69 / 4 / 2 launches a replay, a replay's trace holding the
   kernel events of an eager step, ms per step of the graph, the eager
   kernel path and the bf16 plain path in turns, the graph's idle share,
   pool, peak memory and capture seconds; a chunk with ``D_update_ratio`` 2
   (two graphs); a planted fault (the learning rate a Python float frozen at
   capture) that the comparison fails; (b) the SR step
   (train_RRDB_PSNR.json) in short; (c) a 64-step Z search on the 40 x 40
   selection's crop, graph against eager (trace, Z and best Z), ms per Z
   step of the three paths, a click with its capture and a repeat click;
   (d) the train CLI with ``steps_per_dispatch`` 3 against the per-step run
   (log rows and checkpoints). At most 90 s. With one process, every train
   step, Z step, eval forward (but a trainer's validation) and KernelGAN
   iteration of the earlier phases is a graph replay too (the first of each
   shape captures it); phase 11's ranks run eagerly.

Every phase counts the kernel launches of the path it drives (counters set
to 0 just before, read just after; phase 11 in each rank). The last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
from esr_tpu_torch import train as train_cli
from esr_tpu_torch.cem import CEMConf, kernelgan, make_cem
from esr_tpu_torch.cem.kernels import downsample_kernel_2d, resolve_kernel
from esr_tpu_torch.data import create_dataset, png
from esr_tpu_torch.data.pipeline import make_train_pipeline
from esr_tpu_torch.data.lrhr_dataset import SyntheticDataset
from esr_tpu_torch.data.util import read_img, read_img_uint8, save_img
from esr_tpu_torch.device import full_f32
from esr_tpu_torch.explore import cli as explore_cli
from esr_tpu_torch.explore import objectives as explore_obj
from esr_tpu_torch.explore import viewmodel as explore_vm
from esr_tpu_torch.explore.z_optimizer import ZSearch, ZSearchCache, bucket_crop, optimize_z
from esr_tpu_torch.export import export_servable
from esr_tpu_torch.models import create_model, define_D, define_G, make_eval_forward
from esr_tpu_torch.models.architecture import _up_factors
from esr_tpu_torch.models.base_model import Adam, step_keyed
from esr_tpu_torch.models.blocks import pixel_shuffle, upsample_nearest
from esr_tpu_torch.models.srragan_model import make_gan_train_step
from esr_tpu_torch.ops import tensor2img
from esr_tpu_torch.ops.cuda import autograd as kernel_grads
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
from esr_tpu_torch.scripts import blind_bench
from esr_tpu_torch.scripts import estimate_kernel as estimate_kernel_cli
from esr_tpu_torch.scripts.serve import make_server
from esr_tpu_torch.utils.graphs import GraphedStep

REPO = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA H100 datasheet): bf16 tensor
# cores and HBM3. Bounds are stated against these whatever the power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores: the f32 kernel's bound

F32_TOL = 1e-4  # f32 kernel vs f32 plain: up to 9*256 terms summed in another order
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


@contextlib.contextmanager
def eager_steps():
    """Every ``GraphedStep`` made inside runs each call eagerly: the eager side
    of a graph-against-eager comparison of a path that makes its own
    (KernelGAN's iteration)."""
    init = GraphedStep.__init__

    def eager_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.enabled = False

    GraphedStep.__init__ = eager_init
    try:
        yield
    finally:
        GraphedStep.__init__ = init


def call_ms(fn, reps: int = 10) -> float:
    """Milliseconds from one call of ``fn`` to its answer on the card (the
    host's clock, synchronised before and after), median of ``reps``: the
    latency a single request or render sees, host time included."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def f32_simt_row(kernel: str, site: str, shape: str, fn, plain, library, flops: float, nbytes: float) -> dict:
    """The f32 route (``conv_f32_kernel`` on the FP32 units) at a flagship
    shape: ms beside its plain version and the library call (f32, TF32 off),
    and its bound against the f32 non-tensor peak."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    row = {"kernel": kernel, "site": site, "shape": shape, "ms": cuda_ms(fn, reps=3, windows=3),
           "plain_ms": cuda_ms(plain, reps=3, windows=3),
           "library_ms": None if library is None else cuda_ms(library, reps=3, windows=3),
           "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    lib_ms = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
    print(f"  f32 {kernel:<22s} {site:<11s} {shape:<24s} kernel {row['ms']:.4f} ms, library {lib_ms}, "
          f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
          f"{100 * row['bound_ms'] / row['ms']:.0f}%)", flush=True)
    return row


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# every launch counter: the bf16 and f32 routes of both kernel families, and
# conv_f32_kernel's own (last), which counts each launch of the f32 kernel
ALL_COUNTERS = (rdb_conv.LAUNCHES, *rdb_conv.LAUNCHES_SIMT.values(), kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP,
                *kpack_conv.LAUNCHES_SIMT.values(), kpack_conv.LAUNCHES_F32)
# launches of conv_f32_kernel that one call of each f32 route makes
F32_KERNEL_LAUNCHES = {rdb_conv.LAUNCHES_SIMT["f32"]: 5, **{c: 1 for c in kpack_conv.LAUNCHES_SIMT.values()}}


def launched_once(before: list[int], counter) -> bool:
    """Exactly one call counted since ``before`` (the counts of
    ALL_COUNTERS), on ``counter``, and the launches of conv_f32_kernel that
    its route makes (none for a bf16 route)."""
    want = [int(c is counter) for c in ALL_COUNTERS]
    want[-1] = F32_KERNEL_LAUNCHES.get(counter, 0)
    return [c.count - b for c, b in zip(ALL_COUNTERS, before)] == want


def conv_bf16_band(ref: torch.Tensor, plain_err: float) -> float:
    """Tolerance of a bf16 conv kernel against the f32 plain version on the
    same (bf16-rounded) inputs: twice the bf16 plain version's own error, or
    two bf16 ulps (2^-6 relative) of the largest output, whichever is larger.
    A conv has no skip path, so its largest output is its own work."""
    return max(2.0 * plain_err, 2.0**-6 * ref.abs().max().item())


def gen(shape, seed: int, scale: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()


def rdb_params(seed: int, nf: int = NF, gc: int = GC) -> dict:
    """RDB weights at Kaiming scale (gain sqrt 2), not the generator's x0.1:
    the residual branch 0.2 * x5 then has a std near 0.3 beside x's 1, so a
    band on the block's output sees what the convs compute, not only x."""
    out = {}
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
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
    can go wrong: ragged grids, batch 1, conv_first's Cin 4 and the SR
    trainer's Cin 3 (plain window loads, no TMA), conv_last's Cout 3 (pixels as M, wgmma n8, 2-byte
    stores), both act values; each within the bf16 band and counted as one
    launch."""
    for shape in ((2, 37, 53), (1, 16, 40)):
        for cin, cout in ((3 + NZ, NF), (3, NF), (NF, NF), (NF, 3)):
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

# rdb5c_tc_kernel<64, 32, 16>'s ptxas report (the main path): the kernel's
# when nf 64 / gc 32 / tile 16 was its only shape, on the card's machine's
# nvcc; and the instance's part of its mangled name
RDB_PTXAS = ("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", "Used 168 registers, used 2 barriers")
RDB_MAIN_MANGLED = "ILi64ELi32ELi16E"


def phase_build() -> None:
    secs = lib.build_all()
    for name in lib._SIGNATURES:
        lib.load(name)
        report = lib._lib_path(name).with_suffix(".log").read_text().splitlines()
        usage = [ln.strip() for ln in report if "registers" in ln or "spill" in ln or "C75" in ln]
        print(f"ptxas {name}: " + " | ".join(usage), flush=True)
        if name == "rdb5c":  # every rdb5c_tc_kernel instance: wgmma pipelined, nothing in local memory
            tc = {ln.split("rdb5c_tc_kernel")[1][:20]: report[i + 1:i + 3] for i, ln in enumerate(report)
                  if "Function properties" in ln and "rdb5c_tc_kernel" in ln}
            spilled = {k: v[0].strip() for k, v in tc.items() if not v[0].strip().startswith(RDB_PTXAS[0])}
            serialized = [ln for ln in report if "are serialized" in ln and "rdb5c_tc_kernel" in ln]
            check(len(tc) == len(rdb_conv.INSTANCES) and not spilled and not serialized,
                  f"ptxas rdb5c_tc_kernel: {len(tc)} instances, spilling {spilled}; wgmma serialization "
                  f"warnings: {len(serialized)}")
            main = [v for k, v in tc.items() if k.startswith(RDB_MAIN_MANGLED)]
            line = tuple(ln.replace("ptxas info    :", "").strip() for ln in main[0]) if main else ()
            check(line == RDB_PTXAS, f"ptxas rdb5c_tc_kernel<64, 32, 16> (the main path): {' | '.join(line)} "
                  f"== the single-instance kernel's before: {' | '.join(RDB_PTXAS)}")
            so = lib.load("rdb5c")
            print("rdb5c_tc_kernel instances (nf, gc, tile): shared memory, weight image bytes: " + ", ".join(
                f"{inst} {so.esr_rdb5c_smem_bytes(*inst)} {so.esr_rdb5c_weight_image_bytes(*inst)}"
                for inst in rdb_conv.INSTANCES), flush=True)
        if name == "conv3x3":  # every conv_tc_kernel instance (widths, modes): no spills, wgmma pipelined
            tc = [i for i, ln in enumerate(report) if "Function properties" in ln and "conv_tc_kernel" in ln]
            spilled = [report[i + 1].strip() for i in tc if "0 bytes spill stores" not in report[i + 1]]
            serialized = [ln for ln in report if "are serialized" in ln and "conv_tc_kernel" in ln]
            check(len(tc) == 18 and not spilled and not serialized,
                  f"ptxas conv_tc_kernel: {len(tc)} instances, spilling {spilled}; wgmma serialization "
                  f"warnings: {len(serialized)}")
            # the f32 route: N 8 / 16 / 32 / 64 in both modes, nothing in local memory
            f32 = [i for i, ln in enumerate(report) if "Function properties" in ln and "conv_f32_kernel" in ln]
            spilled = [report[i + 1].strip() for i in f32 if "0 bytes spill stores" not in report[i + 1]]
            check(len(f32) == 8 and not spilled, f"ptxas conv_f32_kernel: {len(f32)} instances, spilling {spilled}")
    print(f"build: {secs:.1f} s (nvcc, all sources in parallel)", flush=True)


# -- phase 3 -------------------------------------------------------------------


@torch.no_grad()
def phase_kernels() -> list[dict]:
    """Each kernel against its plain version. The main path runs the bf16
    tensor-core kernels (both wgmma); the f32 checks run the f32 route
    (``conv_f32_kernel``; the RDB as five of its launches), which only f32
    callers reach. Each bf16 row's ``max_abs_err`` is the bf16 kernel's,
    ``f32_simt_max_abs_err`` the f32 one's; the ``conv_f32`` row gathers the
    f32 route."""
    rows = []
    print(f"tolerances: f32 kernel vs f32 plain {F32_TOL} (up to 9 x 256 products summed in "
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
        before = [c.count for c in ALL_COUNTERS]
        e = max_err(fn(x), rdb5c_reference(x, p))
        ran = launched_once(before, rdb_conv.LAUNCHES_SIMT["f32"])
        check(ran and e <= F32_TOL, f"rdb5c f32 (five conv_f32_kernel launches) {label}: max err {e:.3g} <= "
              f"{F32_TOL}, one launch counted on the f32 RDB counter only {ran}")
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
    before = rdb_conv.LAUNCHES.count
    hinted = fused_rdb5c_tiled(xr.bfloat16(), p, strip=12, wtile=8)
    check(rdb_conv.LAUNCHES.count == before + 1 and torch.equal(hinted, fused_rdb5c(xr.bfloat16(), p)),
          "rdb5c bf16 tile 12x8 is a schedule hint: the tensor-core kernel runs its 16x16 tiles, one launch, "
          "bit for bit the 16x16 answer")
    rdb5c_edge_checks(p)
    flops = 2 * 9 * (sum((NF + k * GC) * GC for k in range(4)) + (NF + 4 * GC) * NF) * B * LR * LR
    nbytes = 2 * xb.numel() * 2 + sum(v.numel() * (2 if k[0] == "w" else 4) for k, v in p.items())
    b_ms, b_by = bound(flops, nbytes)
    kw32 = rdb5c_kernel_weights(p, torch.float32, xm.device)
    rdb_f32 = [f32_simt_row("conv_f32_kernel x5", "RRDB block", "x (16,128,128,64) f32", lambda: rdb5c_launch(xm, kw32),
                            lambda: rdb5c_reference(xm, p), None, flops,
                            2 * xm.numel() * 4 + sum(v.numel() * 4 for v in p.values()))]
    rows.append({
        "name": "rdb5c", "route": "cuda",
        "source": "esr_tpu_torch/ops/cuda/csrc/rdb5c.cuh (rdb5c_tc_kernel<NF, GC, TILE>, three instances; f32: five "
                  "conv_f32.cuh launches)",
        "replaces": "esr_tpu/ops/pallas/rdb_conv.py:163 (fused_rdb5c), :215 (fused_rdb5c_tiled)",
        "tpu_kernel": "K1 fused_rdb5c + K2 fused_rdb5c_tiled",
        "shape": "x (16,128,128,64) bf16, nf 64 gc 32 (instance 64 / 32 / 16; the others: bf16_widths)",
        "max_abs_err": max(bf16_errs), "f32_simt_max_abs_err": max(f32_errs),
        "ms": cuda_ms(lambda: rdb5c_launch(xb, kw5)),
        "plain_ms": cuda_ms(lambda: rdb5c_reference(xb, p)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "launches_per_forward": 3 * NB, "f32_simt": rdb_f32,
    })

    # K3, 3x3 SAME mode: conv_first, trunk_conv, HRconv, conv_last. Kernel
    # times through conv_launch with the weight image built once, as the
    # forward runs it; the library call with its operands prepared outside
    # the timed call.
    hr = LR * SCALE
    sites = [("conv_first", LR, 3 + NZ, NF, False), ("trunk_conv", LR, NF, NF, False),
             ("HRconv", hr, NF, NF, True), ("conv_last", hr, NF, 3, False)]
    f32_errs, bf16_errs, per_site, f32_sites = [], [], [], []
    for i, (site, s, cin, cout, act) in enumerate(sites):
        x = gen((B, s, s, cin), 20 + i)
        w = gen((3, 3, cin, cout), 30 + i, math.sqrt(2.0 / (9 * cin)))
        bias = gen((cout,), 40 + i, 0.01)
        before = [c.count for c in ALL_COUNTERS]
        e = max_err(kpack_conv3x3(x, w, bias, act), conv3x3_reference(x, w, bias, act))
        ran = launched_once(before, kpack_conv.LAUNCHES_SIMT[(3, "f32")])
        check(ran and e <= F32_TOL, f"conv3x3 f32 conv_f32_kernel {site} {cin}->{cout} at {s}x{s}: max err {e:.3g} "
              f"<= {F32_TOL}, one launch counted on its f32 counter only {ran}")
        f32_errs.append(e)
        kw32, xc32, w32 = conv_kernel_weights(w, bias, torch.float32, x.device), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        f32_sites.append(f32_simt_row(
            "conv_f32_kernel", site, f"B{B} {s}x{s} {cin}->{cout}", lambda: conv_launch(x, kw32, act),
            lambda: conv3x3_reference(x, w, bias, act), lambda: F.conv2d(xc32, w32, bias, padding=1),
            2 * 9 * cin * cout * B * s * s, 4 * B * s * s * (cin + cout) + 4 * w.numel()))
        del kw32, xc32, w32
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
        f32_simt=f32_sites,
    ))

    # K3, 2x2 parity mode: the two fused nearest-2x upsample convs
    f32_errs, bf16_errs, per_site, f32_sites = [], [], [], []
    for i, s in enumerate((LR, 2 * LR)):
        x = gen((B, s, s, NF), 50 + i)
        w = gen((3, 3, NF, NF), 60 + i, math.sqrt(2.0 / (9 * NF)))
        bias = gen((NF,), 70 + i, 0.01)
        ref = conv3x3_reference(upsample_nearest(x, 2), w, bias, act=True)
        before = [c.count for c in ALL_COUNTERS]
        e = max_err(upsample2x_conv3x3(x, w, bias, act=True), ref)
        ran = launched_once(before, kpack_conv.LAUNCHES_SIMT[(2, "f32")])
        check(ran and e <= F32_TOL, f"upsample2x_conv3x3 f32 conv_f32_kernel at {s}->{2 * s} vs nearest-2x + "
              f"F.conv2d: max err {e:.3g} <= {F32_TOL}, one launch counted on its f32 counter only {ran}")
        f32_errs.append(e)
        xc = x.permute(0, 3, 1, 2)
        e = max_err(F.leaky_relu(F.conv_transpose2d(xc, convT_weight(w), bias, stride=2, padding=1), 0.2)
                    .permute(0, 2, 3, 1), ref)
        check(e <= F32_TOL, f"library call F.conv_transpose2d computes the same at {s}: max err {e:.3g}")
        del ref
        kw32, w4 = conv_kernel_weights(w, bias, torch.float32, x.device, ksize=2), convT_weight(w)
        f32_sites.append(f32_simt_row(
            "conv_f32_kernel", f"upconv{i + 1}", f"B{B} {s}->{2 * s} 64->64", lambda: conv_launch(x, kw32, True),
            lambda: upsample2x_conv3x3_reference(x, w, bias, act=True),
            lambda: F.conv_transpose2d(xc, w4, bias, stride=2, padding=1),
            2 * 16 * NF * NF * B * s * s, 4 * B * s * s * NF * 5 + 4 * 16 * NF * NF))
        del kw32, w4
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
        f32_simt=f32_sites,
    ))
    conv_edge_checks()
    conv_wide_checks(rows)
    bf16_widths(rows)
    rows.append(f32_route_row(rows))
    return rows


def f32_route_row(rows: list[dict]) -> dict:
    """The f32 route's kernel, ``conv_f32_kernel``, as a row of the kernels
    line: a conv of Cin 256 (which the earlier f32 kernel could not hold in
    shared memory) checked and timed beside the flagship's f32 sites. The
    row's bound is that of one f32 flagship forward's convs (six conv sites,
    69 RDBs); its launches and times are the f32 forward's, which phase 5
    measures (:func:`phase_f32_forward`) and ``main`` fills in."""
    x = gen((B, LR, LR, 256), 95)
    w = gen((3, 3, 256, NF), 96, math.sqrt(2.0 / (9 * 256)))
    bias = gen((NF,), 97, 0.01)
    before = [c.count for c in ALL_COUNTERS]
    e = max_err(kpack_conv3x3(x, w, bias, True), conv3x3_reference(x, w, bias, True))
    ran = launched_once(before, kpack_conv.LAUNCHES_SIMT[(3, "f32")])
    check(ran and e <= F32_TOL, f"conv3x3 f32 conv_f32_kernel Cin 256 -> 64 at B{B} {LR}x{LR} (raised before: "
          f"its window did not fit shared memory): max err {e:.3g} <= {F32_TOL}, one launch counted {ran}")
    kw32, xc, wc = conv_kernel_weights(w, bias, torch.float32, x.device), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    cin256 = f32_simt_row("conv_f32_kernel", "cin256", f"B{B} {LR}x{LR} 256->64", lambda: conv_launch(x, kw32, True),
                          lambda: conv3x3_reference(x, w, bias, True), lambda: F.conv2d(xc, wc, bias, padding=1),
                          2 * 9 * 256 * NF * B * LR * LR, 4 * B * LR * LR * (256 + NF) + 4 * w.numel())
    del x, kw32, xc, wc
    by_name = {r["name"]: r for r in rows}
    conv_sites = by_name["conv3x3"]["f32_simt"] + by_name["upsample2x_conv3x3"]["f32_simt"]
    rdb = by_name["rdb5c"]["f32_simt"][0]
    return {
        "name": "conv_f32", "route": "cuda", "source": "esr_tpu_torch/ops/cuda/csrc/conv_f32.cuh (conv_f32_kernel)",
        "replaces": "esr_tpu/ops/pallas/kpack_conv.py:61 (kpack_conv3x3), its 2x2 window for "
                    "esr_tpu/ops/fused.py:32, and esr_tpu/ops/pallas/rdb_conv.py:163 / :215 (fused_rdb5c, "
                    "five launches), in f32",
        "tpu_kernel": "K1 / K2 / K3 / K3' in f32",
        "shape": f"the CEM-wrapped f32 flagship forward at B{B} x LR {LR} (ms: the kernel path, plain_ms: the f32 "
                 f"plain path, in turns; kernel_device_ms: conv_f32_kernel's device time in it; bound: its six conv "
                 f"sites + {3 * NB} RDBs; library: none, the RDB has no one-call counterpart; each conv site's own "
                 "library time is in its entry)",
        "max_abs_err": max([e] + [r["f32_simt_max_abs_err"] for r in rows]),
        "bound_ms": sum(site["bound_ms"] for site in conv_sites) + 3 * NB * rdb["bound_ms"],
        "library_ms": None, "bound_by": "operations",
        "sites": conv_sites + [rdb, cin256],
    }


def bf16_widths(rows: list[dict]) -> None:
    """The bf16 RDB at widths other than the flagship's, on the RDB kernel's
    other instances (zero-padded to the narrowest that holds them): nf 8 /
    gc 4 and nf 16 / gc 8 (the JAX package runs them) on a ragged grid, and
    at B16 x 128^2 nf 16 / gc 8, nf 32 / gc 16 (instance 32 / 16 / 16) and
    nf 128 / gc 64 (128 / 64 / 8); each within phase 3's band of the f32
    plain version on the same bf16 inputs, one launch counted on the RDB
    kernel's counter and none on any other, timed beside its bound (of the
    unpadded work) and its plain version; no library call computes it.
    Listed under the rdb5c row (``bf16_widths``); the main path runs none of
    them."""
    rdb_row = next(r for r in rows if r["name"] == "rdb5c")
    rdb_row["bf16_widths"] = []
    for i, (shape, nf, gc) in enumerate((((2, 37, 53), 8, 4), ((2, 37, 53), 16, 8), ((B, LR, LR), 16, 8),
                                         ((B, LR, LR), 32, 16), ((B, LR, LR), 128, 64))):
        px = shape[0] * shape[1] * shape[2]
        p = rdb_params(300 + nf + i, nf, gc)
        xb = gen(shape + (nf,), 310 + nf + i).bfloat16()
        kw = rdb5c_kernel_weights(p, torch.bfloat16, xb.device)  # built once, as the forward does
        ref = rdb5c_reference(xb.float(), p)
        tol = 2.0 * max_err(rdb5c_reference(xb, p), ref)
        before = [c.count for c in ALL_COUNTERS]
        got = rdb5c_launch(xb, kw)
        ran = launched_once(before, rdb_conv.LAUNCHES)
        e = max_err(got, ref) if got.shape == ref.shape else math.inf
        del ref, got
        check(ran and e <= tol, f"rdb5c bf16 tensor cores nf {nf} gc {gc} (instance {kw.instance}) {shape}: max err "
              f"{e:.3g} <= {tol:.3g} (twice the bf16 plain version's), one launch counted on its counter only {ran}")
        flops = 2 * 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf) * px
        b_ms, b_by = bound(flops, 2 * 2 * px * nf + sum(v.numel() * (2 if k[0] == "w" else 4) for k, v in p.items()))
        rdb_row["bf16_widths"].append({
            "kernel": f"rdb5c_tc_kernel<{', '.join(map(str, kw.instance))}>",
            "shape": f"x {shape + (nf,)} bf16, nf {nf} gc {gc}", "max_abs_err": e, "band": tol,
            "ms": cuda_ms(lambda: rdb5c_launch(xb, kw)), "plain_ms": cuda_ms(lambda: rdb5c_reference(xb, p)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    for s in rdb_row["bf16_widths"]:
        print(f"  bf16 {s['kernel']:<28s} {s['shape']:<40s} kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
              f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}, {100 * s['bound_ms'] / s['ms']:.1f}%)", flush=True)


CONV_COUNTERS = (kpack_conv.LAUNCHES, kpack_conv.LAUNCHES_UP, *kpack_conv.LAUNCHES_SIMT.values(),
                 kpack_conv.LAUNCHES_F32)


def conv_wide_row(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, ksize: int, what: str,
                  kw=None) -> dict:
    """One bf16 conv wider than 64 channels (Cin in K chunks, Cout in slices)
    on the tensor-core kernel: within phase 3's bf16 conv band of the f32
    plain version on the same bf16 inputs, one launch counted on its mode's
    counter and none on any other conv counter; ms beside the plain version,
    the library call (``F.conv2d``; 2x2 mode: ``F.conv_transpose2d`` with the
    folded weight) and the bound. ``kw``: a prebuilt layout (else built once
    here, as a forward's ``prepare_kernels`` does)."""
    cin, cout = w.shape[2], w.shape[3]
    plain = conv3x3_reference if ksize == 3 else upsample2x_conv3x3_reference
    kw = kw if kw is not None else conv_kernel_weights(w, bias, torch.bfloat16, x.device, ksize)
    ref = plain(x.float(), w, bias, True)
    tol = conv_bf16_band(ref, max_err(plain(x, w, bias, True), ref))
    before = [c.count for c in CONV_COUNTERS]
    got = conv_launch(x, kw, True)
    torch.cuda.synchronize()
    ran = [c.count - b for c, b in zip(CONV_COUNTERS, before)] == [int(ksize == 3), int(ksize == 2), 0, 0, 0]
    e = max_err(got, ref) if got.shape == ref.shape else math.inf
    del ref, got
    check(ran and kw.route == "tc" and e <= tol, f"{what} bf16 tensor cores {ksize}x{ksize} mode {tuple(x.shape)} "
          f"{cin}->{cout}: max err {e:.3g} <= {tol:.3g}, one launch counted on its mode's counter only {ran}")
    xc, bb = x.permute(0, 3, 1, 2), bias.bfloat16()
    if ksize == 3:
        wb = w.permute(3, 2, 0, 1).bfloat16()
        library = lambda: F.conv2d(xc, wb, bb, padding=1)  # noqa: E731
    else:
        wb = convT_weight(w).bfloat16()
        library = lambda: F.conv_transpose2d(xc, wb, bb, stride=2, padding=1)  # noqa: E731
    px, taps, up = x.shape[0] * x.shape[1] * x.shape[2], (9 if ksize == 3 else 16), (1 if ksize == 3 else 4)
    b_ms, b_by = bound(2 * taps * cin * cout * px, 2 * px * (cin + up * cout) + 2 * taps * cin * cout)
    row = {"kernel": "conv_tc_kernel", "shape": f"{what} x {tuple(x.shape)} bf16, {cin}->{cout} lrelu",
           "max_abs_err": e, "band": tol, "ms": cuda_ms(lambda: conv_launch(x, kw, True)),
           "plain_ms": cuda_ms(lambda: plain(x, w, bias, True)), "library_ms": cuda_ms(library),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"  bf16 wide {row['shape']:<58s} kernel {row['ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / row['ms']:.0f}%)", flush=True)
    return row


def conv_wide_checks(rows: list[dict]) -> None:
    """The bf16 convs wider than the flagship's 64 channels, all on the
    tensor-core kernel (the JAX package runs them: SRResNet's 64 -> 256 and,
    at x3, 64 -> 576 upconvs; the JAX kernel's own measured shape had Cout
    128): ragged 2 x 37 x 53 grids at 128 -> 128 and 128 -> 3 in both modes,
    64 -> 96 (a ragged slice) and 64 -> 576 (nine slices), and B16 x 128^2
    128 -> 128 in both modes, where the K-chunk design is judged. Listed
    under the K3 / K3' rows (``bf16_wide``); the flagship's main path runs
    none of them."""
    wide = {"conv3x3": [], "upsample2x_conv3x3": []}
    for i, (shape, cin, cout, modes) in enumerate((
            ((2, 37, 53), 128, 128, (3, 2)), ((2, 37, 53), 128, 3, (3, 2)), ((2, 37, 53), 64, 96, (3, 2)),
            ((2, 37, 53), 64, 576, (3,)), ((B, LR, LR), 128, 128, (3, 2)))):
        w = gen((3, 3, cin, cout), 320 + i, math.sqrt(2.0 / (9 * cin)))
        bias = gen((cout,), 330 + i, 0.01)
        xb = gen(shape + (cin,), 340 + i).bfloat16()
        what = "B16 128x128" if shape == (B, LR, LR) else "ragged"
        for ksize in modes:
            wide["conv3x3" if ksize == 3 else "upsample2x_conv3x3"].append(conv_wide_row(xb, w, bias, ksize, what))
    for r in rows:
        if r["name"] in wide:
            r["bf16_wide"] = wide[r["name"]]


# -- phase 4 -------------------------------------------------------------------


def plain_forward(g, lr: torch.Tensor, z: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """The generator's math on its own weights with every kernel replaced by
    its plain PyTorch version, computing in ``dtype`` (RRDBNet with Z at the
    first layer or at all layers; SRResNet)."""
    x = torch.cat([lr, z if z is not None else lr.new_zeros(lr.shape[:-1] + (NZ,))], -1).to(dtype)

    def conv(m, t):
        return conv3x3_reference(t, m.hwio(), m.bias, m.act)

    fea = conv(g.conv_first, x)
    if not hasattr(g, "RRDB_trunk"):  # SRResNet
        trunk = fea
        for i in range(g.nb):
            blk = getattr(g, f"block{i}")
            trunk = trunk + conv(blk.conv2, F.relu(conv(blk.conv1, trunk)))
        fea = fea + conv(g.trunk_conv, trunk)
        for i, r in enumerate(_up_factors(g.scale)):
            fea = pixel_shuffle(conv(getattr(g, f"upconv{i + 1}"), fea), r)
        return conv(g.conv_last, conv(g.HRconv, fea)).float()
    trunk = fea
    for i, blk in enumerate(g.RRDB_trunk):
        if getattr(g, "all_layers", False):  # the 1x1 latent projection, in dtype
            proj = g.latent_proj[i]
            trunk = F.linear(torch.cat([trunk, x[..., 3:]], -1), proj.weight[:, :, 0, 0].to(dtype), proj.bias.to(dtype))
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
    graphed = make_eval_forward(g, cem)
    fwd = make_eval_forward(g, cem, graphs=False)
    lr = torch.rand(B, LR, LR, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    z = torch.zeros(B, LR, LR, NZ, device="cuda")
    plain = lambda: cem.project(plain_forward(g, lr, z, torch.bfloat16), lr)  # noqa: E731
    plain_graph = GraphedStep(plain, lr.device, "bf16 plain forward")

    def layout_per_call(per_call: bool) -> None:
        """Build the kernels' weight layouts once, as make_eval_forward does,
        or drop them so that every kernel call rebuilds its own (the graphed
        forward sees the layout generation move and captures anew)."""
        g.release_kernels()
        if not per_call:
            g.prepare_kernels()

    # in turns, same card, same process: the bf16 plain path eagerly and as a
    # CUDA graph, the kernel path as the forward's graph, eagerly, and eagerly
    # with the weight layout built per call
    paths = {"plain": plain, "plain, graphed": plain_graph, "kernels, graphed": lambda: graphed(lr, z),
             "kernels": lambda: fwd(lr, z), "kernels, layout per call": lambda: fwd(lr, z)}
    t = {name: [] for name in paths}
    for name in list(paths) + list(paths)[::-1]:
        layout_per_call(name == "kernels, layout per call")
        t[name].append(cuda_ms(paths[name], reps=2, warmup=1, windows=3))
    hr_mp = B * (LR * SCALE) ** 2 / 1e6
    for name, ms in t.items():
        m = statistics.mean(ms)
        print(f"flagship forward B{B} LR{LR} x{SCALE} ({name}): {m:.2f} ms/forward "
              f"({', '.join(f'{v:.2f}' for v in ms)}), {hr_mp / (m / 1e3):.3f} HR MP/s on {card}", flush=True)
    print(f"kernel path / bf16 plain path: {statistics.mean(t['kernels']) / statistics.mean(t['plain']):.3f} "
          f"of the time per forward; graphed: {statistics.mean(t['kernels, graphed']) / statistics.mean(t['plain, graphed']):.3f}"
          f"; kernel path graphed / eager {statistics.mean(t['kernels, graphed']) / statistics.mean(t['kernels']):.3f}",
          flush=True)
    del graphed, plain_graph

    # where the kernel path's time goes: device time by kernel over two eager forwards
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            fwd(lr, z)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile, 2 forwards (kernels, eager): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
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
    lib_ms = sum(r["library_ms"] for r in rows if r["name"] in ("conv3x3", "upsample2x_conv3x3"))
    print(f"conv_tc_kernel (3x3 and 2x2 modes, {sum(e.count for e in conv) // 2} launches): "
          f"{conv_ms:.3f} ms of device time per forward; the library calls for the same six convs "
          f"(phase 3): {lib_ms:.3f} ms", flush=True)
    for e in sorted(conv, key=lambda e: e.key):
        print(f"  {e.self_device_time_total / 1e3 / 2:9.3f} ms/forward x{e.count // 2:<3d} {e.key[:90]}", flush=True)


# the f32 route's path: the flagship forward with "bf16": false, per forward:
# calls of each f32 route, and conv_f32_kernel's launches (five an RDB)
F32_PER_FORWARD = {"rdb5c_simt_f32": 3 * NB, "conv3x3_simt_f32": 4, "upsample2x_conv3x3_simt_f32": 2,
                   "conv_f32_kernel": 5 * 3 * NB + 4 + 2}


@torch.no_grad()
def phase_f32_forward(card: str) -> dict:
    """Phase 5, the f32 route: the CEM-wrapped flagship with ``"bf16":
    false`` (what the JAX package evaluates at ``eval_precision: "highest"``)
    at B16 x LR 128, its layouts built once (make_eval_forward). Checks, on
    one forward with every counter zeroed just before: its launches on the
    f32 counters (69 RDBs, 4 + 2 convs, 351 conv_f32_kernel launches) and
    none on the bf16 ones, the answer's shape and finiteness, the CEM
    residual, and its max error against the f32 plain path within F32_TOL,
    a band that the same plain path with cuDNN's TF32 on must miss by 4x.
    Then ms per forward beside the f32 plain path in turns (plain, kernels,
    kernels, plain) and conv_f32_kernel's device time in one forward (the
    profiler). Returns the launches and the measured numbers."""
    opt = {"network_G": {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ}, "scale": SCALE, "bf16": False}
    g = define_G(opt, device="cuda", seed=0)
    dev = next(g.parameters()).device
    cem = make_cem(CEMConf(scale=SCALE), device=dev)
    fwd = make_eval_forward(g, cem)
    lr = torch.rand(B, LR, LR, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    z = torch.zeros(B, LR, LR, NZ, device=dev)
    out, counts, _ = counted(lambda: fwd(lr, z), ALL_COUNTERS)
    want = {c.name: F32_PER_FORWARD.get(c.name, 0) for c in ALL_COUNTERS}
    check(counts == want, f"f32 flagship forward B{B} x LR {LR}: launches {counts} == {want}")
    check(tuple(out.shape) == (B, SCALE * LR, SCALE * LR, 3) and bool(torch.isfinite(out).all()),
          f"f32 flagship forward: answer {tuple(out.shape)}, every value finite")
    res = max_err(cem.downsample(out), lr)
    check(res <= CEM_TOL, f"f32 flagship forward: CEM residual max|H(out) - lr| {res:.3g} <= {CEM_TOL}")
    plain = lambda: cem.project(plain_forward(g, lr, z, torch.float32), lr)  # noqa: E731
    ref = plain()
    err = max_err(out, ref)
    del out
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=True):
        tf32_err = max_err(plain(), ref)
    del ref
    check(err <= F32_TOL and 4 * F32_TOL <= tf32_err,
          f"f32 flagship forward vs the f32 plain path: max err {err:.3g} <= {F32_TOL}, a band that the f32 plain "
          f"path with cuDNN's TF32 on misses by 4x or more (off by {tf32_err:.3g})")
    t = {"plain": [], "kernels": []}
    for name in ("plain", "kernels", "kernels", "plain"):
        t[name].append(cuda_ms(plain if name == "plain" else lambda: fwd(lr, z), reps=2, warmup=1, windows=2))
    hr_mp = B * (LR * SCALE) ** 2 / 1e6
    for name, ms in t.items():
        m = statistics.mean(ms)
        print(f"f32 flagship forward B{B} LR{LR} x{SCALE} ({name}, f32, TF32 off): {m:.2f} ms/forward "
              f"({', '.join(f'{v:.2f}' for v in ms)}), {hr_mp / (m / 1e3):.3f} HR MP/s on {card}", flush=True)
    print(f"f32 kernel path / f32 plain path: {statistics.mean(t['kernels']) / statistics.mean(t['plain']):.3f} "
          "of the time per forward", flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd(lr, z)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    conv = [e for e in kernels if "conv_f32_kernel" in e.key]
    conv_ms = sum(e.self_device_time_total for e in conv) / 1e3
    print(f"profile, 1 f32 forward: device busy {busy_ms:.2f} ms, conv_f32_kernel {conv_ms:.2f} ms "
          f"({sum(e.count for e in conv)} launches, {100 * conv_ms / max(busy_ms, 1e-9):.1f}% of busy)", flush=True)
    return {"launches": counts, "ms": statistics.mean(t["kernels"]), "plain_ms": statistics.mean(t["plain"]),
            "kernel_device_ms": conv_ms, "max_abs_err": err, "tf32_control_err": tf32_err}


# -- phase 5, the other bf16 widths -------------------------------------------------

# (nf, gc, batch) of the full-depth generators on the RDB kernel's other
# instances: B16 x LR 128 at nf 32, B4 at the widest
WIDTH_FORWARDS = ((32, 16, B), (128, 64, 4))


@torch.no_grad()
def phase_widths_forward() -> dict[str, dict]:
    """Phase 5, the RDB kernel's other instances on a whole generator: the
    CEM-wrapped RRDBNet at nb 23 with seeded weights and each width of
    ``WIDTH_FORWARDS`` through ``make_eval_forward`` (its graph): 69 / 4 / 2
    launches, PSNR against the f32 plain path within phase 10(f)'s band (the
    bf16 plain path's less PSNR_MARGIN_DB), ms beside the bf16 plain path,
    and the CEM residual within CEM_TOL or the bf16 plain path's own,
    whichever is larger: the seeded nf 32 generator's outputs (up to ~34)
    take CEM's f32 projection to ~1.1e-5 on the plain path too. Returns the
    launches by path."""
    paths = {}
    for nf, gc, batch in WIDTH_FORWARDS:
        opt = {"network_G": {"nf": nf, "nb": NB, "gc": gc, "num_latent_channels": NZ}, "scale": SCALE, "bf16": True}
        g = define_G(opt, device=BLIND_DEVICE, seed=0)
        paths[f"forward_nf{nf}_gc{gc}"] = variant_forward(g, f"RRDBNet nf {nf} gc {gc} nb {NB}", COUNTERS,
                                                          EXPECTED_PER_FORWARD, batch=batch, residual_as_plain=True)
        del g
        torch.cuda.empty_cache()
    return paths


# -- phase 5, the forward as CUDA graphs ------------------------------------------

# the shapes the port's callers give the eval forward (LR batch, height, width, Z): the bench shape
# (phase 5), the serving buckets (phase 7; 1x128x128 is also the explorer's render of its LR 128 image,
# phase 9), graft_entry.entry()'s B2 x LR 64 (phase 12), and a request's LR 96x80 unpadded (phase 4)
GRAPH_SHAPES = (("B16 x LR 128", B, LR, LR, "zeros"), ("serving bucket 1x64x64", 1, 64, 64, "random"),
                ("serving bucket 1x128x128, the explorer's render", 1, 128, 128, "random"),
                ("serving bucket 1x96x96", 1, 96, 96, "random"), ("B2 x LR 64, graft_entry", 2, 64, 64, "zeros"),
                ("request LR 96x80", 1, 96, 80, None))


@torch.no_grad()
def phase_forward_graphs(card: str) -> dict:
    """Phase 5, the eval forward as one CUDA graph per input shape
    (``EvalForward``) against the same forward eagerly, flagship width, bf16
    kernels, CEM, cuDNN deterministic: at every shape of GRAPH_SHAPES the
    capture call and two replays on new inputs bit for bit, 69 / 4 / 2
    launches a replay, capture seconds and the pool's growth; a replay's
    trace holds the kernels of an eager forward from one graph launch; ms per
    forward of the graph, the eager kernel path and the bf16 plain path as a
    graph, in turns, at B2 x LR 64 and the 1x64x64 bucket; the cost of the
    answer's copy at B16 x LR 128; and a planted fault: a forward that keeps
    its graphs after new weights' layouts are built answers with the old
    weights, and the layout generation check is what catches it. Returns
    the launches of one B16 x LR 128 replay."""
    opt = {"network_G": {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ}, "scale": SCALE, "bf16": True}
    g = define_G(opt, device="cuda", seed=0)
    cem = make_cem(CEMConf(scale=SCALE), device="cuda")
    graphed, eager = make_eval_forward(g, cem), make_eval_forward(g, cem, graphs=False)
    rng = np.random.default_rng(14)

    def inputs(n, h, w, z_kind):
        lr = torch.from_numpy(rng.random((n, h, w, 3), dtype=np.float32)).cuda()
        if z_kind is None:
            return lr, None
        z = rng.uniform(-1, 1, (n, h, w, NZ)).astype(np.float32) if z_kind == "random" else \
            np.zeros((n, h, w, NZ), np.float32)
        return lr, torch.from_numpy(z).cuda()

    torch.backends.cudnn.deterministic = True
    try:
        replay_counts = None
        for what, n, h, w, z_kind in GRAPH_SHAPES:
            same, counts, grew = [], [], None
            for _ in range(3):  # the capture call, then two replays
                lr, z = inputs(n, h, w, z_kind)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                r0 = torch.cuda.memory_reserved()
                out, c, _ = counted(lambda: graphed(lr, z))
                grew = (torch.cuda.memory_reserved() - r0) / 2**30 if grew is None else grew
                counts.append(c)
                same.append(torch.equal(out, eager(lr, z)))
            step = graphed.graphs.steps[-1]
            check(all(same) and all(c == EXPECTED_PER_FORWARD for c in counts) and step.graph is not None,
                  f"phase 5 graphed forward, {what} ({n}x{h}x{w}, Z {z_kind}): the capture call and two replays == "
                  f"the eager forward bit for bit {same}; launches a call {counts[-1]} == {EXPECTED_PER_FORWARD}; "
                  f"capture {step.capture_seconds:.3f} s; the capture call's reserved memory +{grew:.3f} GiB (its "
                  f"eager warm-up, then the graph's pool, shared by the shapes) on {card}")
            if n == B:
                replay_counts = counts[-1]
        check(len(graphed.graphs.steps) == len(GRAPH_SHAPES),
              f"phase 5 graphed forward: one graph per input shape ({len(graphed.graphs.steps)} for "
              f"{len(GRAPH_SHAPES)} shapes)")

        # a replay's trace: the kernels of an eager forward, from one graph launch
        lr, z = inputs(B, LR, LR, "zeros")
        with tempfile.TemporaryDirectory(prefix="forward_trace_") as d:
            k_replay, split = traced(Path(d), "forward_replay", lambda: graphed(lr, z), lambda: graphed(lr, z))
            k_eager, _ = traced(Path(d), "forward_eager", lambda: eager(lr, z), lambda: eager(lr, z))
        want_k = {"rdb5c_tc_kernel": EXPECTED_PER_FORWARD["rdb5c"],
                  "conv_tc_kernel": EXPECTED_PER_FORWARD["conv3x3"] + EXPECTED_PER_FORWARD["upsample2x_conv3x3"]}
        check(k_replay == k_eager == want_k and split["graph_launches"] == 1,
              f"phase 5 profiler trace of one B{B} x LR {LR} forward replay: kernel events {k_replay} == an eager "
              f"forward's {k_eager} == {want_k}; {split['graph_launches']} graph launch, {split['launches']} launch "
              f"calls in all; device busy {split['device_busy_ms']:.2f} ms")

        # ms per forward where the host's share is largest, in turns: graph, eager kernels, bf16 plain as a graph
        for what, n, h, w, z_kind in (GRAPH_SHAPES[4], GRAPH_SHAPES[1]):
            lr, z = inputs(n, h, w, z_kind)
            plain = GraphedStep(lambda: cem.project(plain_forward(g, lr, z, torch.bfloat16), lr), lr.device,  # noqa: B023
                                "bf16 plain forward")
            paths = {"graph": lambda: graphed(lr, z), "eager kernels": lambda: eager(lr, z),  # noqa: B023
                     "bf16 plain, graphed": plain}
            t, lat = {k: [] for k in paths}, {k: [] for k in paths}
            for name in list(paths) + list(paths)[::-1]:
                t[name].append(cuda_ms(paths[name], reps=10, warmup=2, windows=3))
                lat[name].append(call_ms(paths[name]))
            ms = {k: statistics.mean(v) for k, v in t.items()}
            one = {k: statistics.mean(v) for k, v in lat.items()}
            print(f"phase 5 forward {what} ({n}x{h}x{w}) on {card}, back to back (CUDA events): " + ", ".join(
                f"{k} {v:.3f} ms ({', '.join(f'{x:.3f}' for x in t[k])})" for k, v in ms.items())
                + f"; graph / eager {ms['graph'] / ms['eager kernels']:.3f}; one call to its answer on the host's "
                f"clock (median of 10): " + ", ".join(f"{k} {v:.3f} ms" for k, v in one.items())
                + f"; graph / eager {one['graph'] / one['eager kernels']:.3f}", flush=True)
            del plain, paths
        lr, z = inputs(B, LR, LR, "zeros")
        out = graphed(lr, z)
        copy_ms = cuda_ms(lambda: out.clone(), reps=10, warmup=2, windows=3)
        fwd_ms = cuda_ms(lambda: graphed(lr, z), reps=2, warmup=1, windows=3)
        print(f"phase 5 the answer's copy out of the graph at B{B} x LR {LR} ({out.numel() * 4 / 2**20:.1f} MiB f32): "
              f"{copy_ms:.4f} ms of {fwd_ms:.2f} ms a graphed forward ({100 * copy_ms / fwd_ms:.2f}%) on {card}",
              flush=True)
        del out

        # the planted fault: new weights and their layouts, a forward that keeps its old graphs
        n, h, w = 2, 64, 64
        lr, z = inputs(n, h, w, "random")
        kept, checked = make_eval_forward(g, cem), make_eval_forward(g, cem)
        kept._sync_layouts = lambda: None  # the copy with the generation check removed
        old = [kept(lr, z), kept(lr, z), checked(lr, z), checked(lr, z)][-1]
        old_layouts = [m.kernel_weights for m in g._kernel_modules()]  # alive: a stale graph reads the old weights
        g.load_state_dict(define_G(opt, device="cuda", seed=1).state_dict())
        g.prepare_kernels()
        fresh = make_eval_forward(g, cem, graphs=False)(lr, z)
        got, stale = checked(lr, z), kept(lr, z)
        check(torch.equal(got, fresh) and not torch.equal(fresh, old) and len(checked.graphs.steps) == 1,
              f"phase 5 stale layouts: after new weights and prepare_kernels, the forward drops its graphs "
              f"(generation {checked.generation}) and answers as a fresh eager forward bit for bit; max |new - old| "
              f"{max_err(fresh, old):.3g}")
        check(torch.equal(stale, old) and not torch.equal(stale, fresh),
              f"phase 5 planted fault, the generation check removed: the kept graph answers with the old weights "
              f"(== the old answer {torch.equal(stale, old)}, max |stale - fresh| {max_err(stale, fresh):.3g}): the "
              "comparison with a fresh forward fails it")
        del old_layouts, kept, checked
    finally:
        torch.backends.cudnn.deterministic = False
    return replay_counts


# -- phases 6 and 7: the inference entry points --------------------------------

METRIC_TOL = {"psnr": 1e-3, "z_psnr_mean": 1e-3, "z_psnr_spread": 2e-3, "ssim": 1e-5, "z_ssim_mean": 1e-5}
# batched vs serial: the same kernels per image, the CEM matmuls at another
# batch size; PSNR within 1e-3 dB, SSIM 1e-5, Z diversity 1e-3 relative


def counted(fn, counters=COUNTERS):
    """Run ``fn`` with every launch counter set to 0 just before; returns
    (its result, the launches by kernel, wall seconds to a synchronised end)."""
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {c.name: c.count for c in counters}, time.perf_counter() - t0


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
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0, walls = torch.cuda.memory_reserved(), []
        for zi in (0, 2):  # the first call of the padded shape captures its graph, the second replays it
            t0 = time.perf_counter()
            model.feed_data({"LR": lr_p})
            model.test(z=eval_cli._eval_z_draw(idx, zi - 1, lr_p.shape[:2], NZ) if zi else None)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            want = eval_cli._sr_image(model.get_visuals_uint8()["SR"], orig, SCALE)
            saved = read_img_uint8(str(out_dir / f"{name}{'_z%d' % zi if zi else ''}.png"))
            check(saved.shape == want.shape and bool((saved == want).all()),
                  f"eval: saved {name} draw {zi} PNG {saved.shape} decodes to the SR uint8 (LR {lr_p.shape[:2]})")
        step = model._forward.graphs.steps[-1]
        print(f"eval forward graph of the {name} image's padded LR {lr_p.shape[:2]}: capture {step.capture_seconds:.3f} "
              f"s; first call (warm-up + capture) {walls[0]:.3f} s, a replay's call {walls[1]:.3f} s (model.test, "
              f"to the SR on the card); reserved memory +{(torch.cuda.memory_reserved() - r0) / 2**30:.3f} GiB "
              "(the warm-up's blocks and the graph's pool, which the model's shapes share)", flush=True)
    check(len(model._forward.graphs.steps) == 2, f"eval: one forward graph per padded shape "
          f"({len(model._forward.graphs.steps)} for the two folder images)")
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
    t_big_eager = timed(1, 512, 352, f=make_eval_forward(g, cem, graphs=False), **kw)
    t_se = timed(1, 510, 339, f=make_eval_forward(g, cem, self_ensemble=True), reps=1, warmup=1, windows=3)
    t_big_raw = timed(1, 510, 339, **kw)
    print(f"eval forward device ms per image per draw (CEM included; CUDA graphs): serial LR 128x128 {t_syn:.2f}, "
          f"batched 4 x 128x128 {t_syn4:.2f}; DIV2K-sized bucket 512x352 {t_big:.2f} (eager {t_big_eager:.2f}), "
          f"unpadded 510x339 {t_big_raw:.2f}; ragged bucket 128x96 {t_rag:.2f}; self-ensemble 510x339 {t_se:.2f} "
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
    sv, live = server.servable, make_eval_forward(model.g_module, model.cem, graphs=False)
    check(len(sv.forward.graphs.steps) == len(buckets) and all(st.graph is not None for st in sv.forward.graphs.steps),
          f"serve: make_server's warm-up captured one forward graph per bucket "
          f"({len(sv.forward.graphs.steps)} for {len(buckets)}; capture s "
          f"{[round(st.capture_seconds, 3) for st in sv.forward.graphs.steps]})")
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
            same = torch.equal(sv.forward(lr_p, z_p), out)
            check(sr.shape == (SCALE * h, SCALE * w, 3) and bool((sr == want_sv).all()) and bool((sr == want_live).all())
                  and same, f"serve {what}: answer {sr.shape} == live Servable == the eager forward on the padded LR "
                  f"{(bh, bw)} cropped; the Servable's graph == the eager forward bit for bit {same}; CEM residual "
                  f"{res:.3g} <= {CEM_TOL}; {secs * 1e3:.1f} ms")
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
        eager_ms = cuda_ms(lambda: live(lr_p, z_p), reps=5, warmup=1, windows=3)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            post_sr(url, request, {"X-Z-Mode": "random", "X-Z-Seed": "1"})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print("serve request LR 96x80 (bucket 96x96), host ms (median of 5): " +
              ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f"; forward on the card {fwd_ms:.2f} ms as "
              f"its graph, {eager_ms:.2f} ms eagerly (CUDA events, CEM included); one request under the profiler: "
              f"wall {wall_ms:.2f} ms, device "
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

# -- phase 8: training -----------------------------------------------------------

TRAIN_HR = 128  # the train crop of train_explorable_SR.json (LR 32x32)
NOISE_GRADS = ("conv_last.bias",)  # zero in exact arithmetic: the CEM projection removes a constant shift
GRAD_BAND_FLOOR = 2.0**-8  # a bf16 half-ulp: the least relative L2 band a gradient is held to


def train_options(tmp: Path, name: str, json_name: str, val_dir: Path | None, niter: int, **train) -> dict:
    """The port's copy of ``json_name`` (full width), on the SYNTHETIC train
    set at B16 x HR 128 (32 images: epochs of 2 batches), one val PNG,
    ``niter`` steps, a checkpoint every 3, watchdog off."""
    opt = json.loads((REPO / "esr_tpu_torch" / "options" / "train" / json_name).read_text())
    opt["name"] = name
    opt["datasets"] = {"train": {"name": "synthetic", "mode": "SYNTHETIC", "n_images": 32, "image_size": 160,
                                 "batch_size": B, "HR_size": TRAIN_HR, "use_flip": True, "use_rot": True}}
    if val_dir is not None:
        opt["datasets"]["val"] = {"name": "val", "mode": "LRHR", "dataroot_HR": str(val_dir)}
    opt["path"] = {"root": str(tmp)}
    opt["train"].update(niter=niter, val_freq=3, watchdog=False, **train)
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 3}
    return opt


def run_train(tmp: Path, opt: dict, *flags: str, counters=COUNTERS):
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / f"{opt['name']}_{opt['train']['niter']}.json"
    path.write_text(json.dumps(opt))
    return counted(lambda: train_cli.main(["-opt", str(path), *flags]), counters)


def train_state(tmp: Path, name: str, it: int) -> dict:
    return torch.load(tmp / "experiments" / name / "training_state" / f"{it}.state", map_location="cpu",
                      weights_only=True)


def train_csv(tmp: Path, name: str) -> list[dict]:
    import csv

    with open(tmp / "experiments" / name / "train_metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


class GradCapture(Adam):
    """Stands in for a trainer's Adam: keeps the gradients, changes nothing
    (it counts and stages step scalars as Adam does)."""

    def __init__(self, params):
        super().__init__(params)
        self.grads = None

    def step(self, grads, lr=None, sq_sum=None) -> None:  # noqa: ARG002
        self.grads = [g.float() for g in grads]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


def grad_band(names: list[str], g_k: list, g_b: list, g_f: list) -> tuple[float, list, list]:
    """G's gradients ``g_k`` against the f32 plain path's ``g_f``: the worst
    ratio of a tensor's relative L2 to its band (twice the bf16 plain path's,
    at least ``GRAD_BAND_FLOOR``), and the relative L2s of ``g_k`` and ``g_b``."""
    worst, rows_k, rows_b = 0.0, [], []
    for n, gk, gb, gf in zip(names, g_k, g_b, g_f):
        if n in NOISE_GRADS:
            continue
        rk, rb = rel_l2(gk, gf), rel_l2(gb, gf)
        rows_k.append(rk)
        rows_b.append(rb)
        worst = max(worst, rk / max(2 * rb, GRAD_BAND_FLOOR))
    return worst, rows_k, rows_b


class KeepProjected:
    """The CEM with the last image it projected kept: the train step's fake."""

    def __init__(self, cem):
        self.cem, self.fake = cem, None

    def __getattr__(self, name):
        return getattr(self.cem, name)

    def project(self, sr, lr):
        self.fake = self.cem.project(sr, lr)
        return self.fake


_RDB_KEYS = tuple(f"{p}{k}" for k in range(1, 6) for p in ("w", "b"))


def rdb_band(ref: torch.Tensor, plain_err: float) -> float:  # noqa: ARG001
    """Phase 3's RDB band: twice the bf16 plain version's error."""
    return 2.0 * plain_err


def with_act(conv, act: bool):
    """``conv(x, kernel, bias, act)`` as a function of (x, kernel, bias)."""
    return lambda x, kernel, bias: conv(x, kernel, bias, act)


def train_fn_checks() -> None:
    """Each kernel's autograd Function (what the train step's G calls) at the
    shapes a B16 x HR 128 step gives it, on bf16 inputs and f32 weights as
    the step has them: its output against the f32 plain version in phase 3's
    band (rdb5c: twice the bf16 plain version's error, at Kaiming-scale
    weights where the band is shown to see a faulty kernel; convs: the same
    or two bf16 ulps of the largest output), one launch counted per call,
    and its x, w, b gradients for a seeded upstream gradient against the f32
    plain version's in the conv band, x's in bf16 and the weights' in f32."""
    s = TRAIN_HR // SCALE
    p = rdb_params(200)

    def rdb_fn(x, *wb):
        return kernel_grads.rdb5c_fn(x, dict(zip(_RDB_KEYS, wb)))

    def rdb_plain(x, *wb):
        return rdb5c_reference(x, dict(zip(_RDB_KEYS, wb)))

    sites = [("rdb5c", (B, s, s, NF), rdb_fn, rdb_plain, [p[k] for k in _RDB_KEYS], rdb_conv.LAUNCHES, rdb_band)]
    for i, (site, size, cin, cout, act, up) in enumerate((
            ("conv_first", s, 3 + NZ, NF, False, False), ("trunk_conv", s, NF, NF, False, False),
            ("upconv1", s, NF, NF, True, True), ("upconv2", 2 * s, NF, NF, True, True),
            ("HRconv", 4 * s, NF, NF, True, False), ("conv_last", 4 * s, NF, 3, False, False))):
        w = gen((3, 3, cin, cout), 230 + i, math.sqrt(2.0 / (9 * cin)))
        fn, plain = ((kernel_grads.upsample2x_conv3x3_fn, upsample2x_conv3x3_reference) if up
                     else (kernel_grads.conv3x3_fn, conv3x3_reference))
        sites.append((site, (B, size, size, cin), with_act(fn, act), with_act(plain, act),
                      [w, gen((cout,), 240 + i, 0.01)], kpack_conv.LAUNCHES_UP if up else kpack_conv.LAUNCHES,
                      conv_bf16_band))
    for j, (site, shape, fn, plain, params, counter, band) in enumerate(sites):
        xb = gen(shape, 250 + j).bfloat16()
        before = counter.count
        leaves = [xb.clone().requires_grad_(True)] + [q.clone().requires_grad_(True) for q in params]
        y = fn(*leaves)
        ran = counter.count == before + 1
        gy = gen(tuple(y.shape), 270 + j).bfloat16()
        grads = torch.autograd.grad(y, leaves, gy)

        def plain_grads(dtype):
            ls = [xb.to(dtype).detach().requires_grad_(True)] + [q.clone().requires_grad_(True) for q in params]
            out = plain(*ls)
            return out.detach(), torch.autograd.grad(out, ls, gy.to(out.dtype))

        ref, g_ref = plain_grads(torch.float32)
        out_b, g_b = plain_grads(torch.bfloat16)
        tol = band(ref, max_err(out_b, ref))
        e = max_err(y, ref) if y.shape == ref.shape else math.inf
        if site == "rdb5c":
            for fault, yf in rdb_faults(xb.float(), dict(zip(_RDB_KEYS, params))).items():
                off = max_err(yf, ref)
                check(4.0 * tol <= off, f"{site} Function band {tol:.3g} at {shape} sees a kernel that {fault} "
                      f"(off by {off:.3g})")
        worst_g, dtypes_ok = 0.0, grads[0].dtype == torch.bfloat16
        for gk, gr, gb in zip(grads, g_ref, g_b):
            worst_g = max(worst_g, max_err(gk, gr) / max(conv_bf16_band(gr, max_err(gb, gr)), 1e-30))
        dtypes_ok = dtypes_ok and all(gk.dtype == torch.float32 for gk in grads[1:])
        check(ran and e <= tol and worst_g <= 1.0 and dtypes_ok,
              f"{site} autograd Function at the train shape {shape}: output max err {e:.3g} <= {tol:.3g}, "
              f"one launch counted {ran}; x, w, b gradients worst {worst_g:.3f} of their band, dtypes "
              f"{[str(gk.dtype)[6:] for gk in grads[:3]]}")


def planted_faults() -> dict:
    """Stand-ins for the kernels inside the autograd Functions, each
    computing what a faulty kernel would: name -> (attribute of
    ``kernel_grads``, replacement, whether the G-gradient band must fail
    it). An RDB kernel that skips the image-edge zeroing moves G's gradients
    and fake by less than bf16 rounding does at G's initial weights (its
    residual branch is 0.2 x a 0.1-scaled block), so no step-level band can
    see it; the Function check at the train shape does (``train_fn_checks``)."""
    conv = kernel_grads._conv_live

    def conv_edge(x, kernel, bias, act, ksize):
        if ksize != 3:
            return conv(x, kernel, bias, act, ksize)
        xp = F.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
        return conv3x3_reference(xp.to(x.dtype), kernel, bias, act)[:, 1:-1, 1:-1].contiguous()

    return {
        "rdb5c kernel returns x": ("_rdb5c_live", lambda x, params: x.clone(), True),
        "rdb5c kernel skips the image-edge zeroing": (
            "_rdb5c_live",
            lambda x, params: rdb5c_reference(F.pad(x, (0, 0, 5, 5, 5, 5)), params)[:, 5:-5, 5:-5].contiguous(),
            False),
        "conv3x3 kernel pads with the edge pixels, not zeros": ("_conv_live", conv_edge, True),
    }


def phase_train(tmp: Path) -> dict[str, dict]:
    """The train CLI at full width, resume, the SR trainer, the gradient
    band, and timing; returns the launches by path."""
    val_dir = tmp / "train_val"
    to_u8 = lambda a: (a * 255.0).round().astype(np.uint8)  # noqa: E731
    save_img(to_u8(SyntheticDataset({"phase": "test", "image_size": 256})._make_image(9)), str(val_dir / "val.png"))
    launches = {}
    per_forward = EXPECTED_PER_FORWARD
    # the resume check compares runs: deterministic cuDNN algorithms for them
    torch.backends.cudnn.deterministic = True
    name = "train_gan"
    opt = train_options(tmp / "straight", name, "train_explorable_SR.json", val_dir, niter=6)
    _, counts, secs = run_train(tmp / "straight", opt)
    # 6 steps (one G forward each) + validation at 3 and 6 (one image each)
    want = {k: v * 8 for k, v in per_forward.items()}
    check(counts == want, f"train CLI, 6 GAN steps + 2 val forwards: launches {counts} == {want} (the backward "
          f"launches none); {secs:.1f} s")
    launches["train"] = counts
    rows = train_csv(tmp / "straight", name)
    check([int(r["step"]) for r in rows] == list(range(1, 7)) and all(
        math.isfinite(float(v)) for r in rows for k, v in r.items() if k not in ("step", "epoch")),
        f"train CLI: 6 rows of finite metrics in train_metrics.csv (last: l_g {float(rows[-1]['l_g']):.4f}, "
          f"l_d {float(rows[-1]['l_d']):.4f}, psnr {float(rows[-1]['psnr']):.2f})")
    models = sorted(p.name for p in (tmp / "straight" / "experiments" / name / "models").iterdir())
    check(models == ["3_D.pth", "3_G.pth", "6_D.pth", "6_G.pth", "latest_D.pth", "latest_G.pth"],
          f"train CLI checkpoints: {models}")

    # 3 steps, then --auto_resume to 6: the straight run's trajectory
    opt3 = train_options(tmp / "resumed", name, "train_explorable_SR.json", val_dir, niter=3)
    _, c3, _ = run_train(tmp / "resumed", opt3)
    _, c6, _ = run_train(tmp / "resumed", dict(opt3, train=dict(opt3["train"], niter=6)), "--auto_resume")
    a, b = train_state(tmp / "straight", name, 6), train_state(tmp / "resumed", name, 6)
    diff = max((a[n]["net"][k].float() - v.float()).abs().max().item()
               for n in ("G", "D") for k, v in b[n]["net"].items())
    rows_r = train_csv(tmp / "resumed", name)
    ldiff = max(abs(float(r[k]) - float(s[k])) / max(abs(float(s[k])), 1e-12)
                for r, s in zip(rows_r, rows) for k in s if k not in ("step", "epoch"))
    check(b["iter"] == 6 and len(rows_r) == 6 and diff <= 1e-6 and ldiff <= 1e-5,
          f"train CLI: 3 steps + --auto_resume + 3 == 6 straight steps: weights max diff {diff:.3g}, metrics max "
          f"relative diff {ldiff:.3g}; launches {c3} + {c6}")
    torch.backends.cudnn.deterministic = False

    # the SR (PSNR) trainer, 2 steps
    opt_sr = train_options(tmp / "sr", "train_sr", "train_RRDB_PSNR.json", None, niter=2)
    _, counts, secs = run_train(tmp / "sr", opt_sr)
    want = {k: v * 2 for k, v in per_forward.items()}
    rows = train_csv(tmp / "sr", "train_sr")
    check(counts == want and len(rows) == 2 and all(math.isfinite(float(r["l_pix"])) for r in rows),
          f"SR trainer, 2 steps: launches {counts} == {want}; l_pix {[round(float(r['l_pix']), 5) for r in rows]}; "
          f"{secs:.1f} s")
    launches["train_sr"] = counts

    # one fixed batch and Z: G's gradients through the kernels against the
    # bf16 and f32 plain paths, on the same weights
    model = create_model(parse(train_options(tmp / "grads", "grads", "train_explorable_SR.json", None, niter=1),
                               is_train=True))
    g, cem = model.g_module, model.cem
    ds = SyntheticDataset({"phase": "train", "n_images": B, "image_size": 160, "HR_size": TRAIN_HR})
    hr_u8 = torch.from_numpy(np.stack([ds[i]["HR"] for i in range(B)])).cuda()
    batch = make_train_pipeline(num_latent_channels=NZ)(hr_u8, torch.Generator().manual_seed(0))
    lr, z = batch["LR"], batch["Z"]

    def grad_step(g_call):
        """One train step on the fixed batch with Adam replaced by capture:
        its metrics, G's gradients and its projected fake."""
        cap, dcap = GradCapture(g.parameters()), GradCapture(model.d_module.parameters())
        stats = {k: v.clone() for k, v in model.d_module.state_dict().items()}
        kept = KeepProjected(cem)
        step = make_gan_train_step(g_call, model.d_module, model.f_module, kept, lambda h, gen: batch,
                                   model.opt["train"], cap, dcap, model.schedulers["G"],
                                   step_keyed(model.schedulers["D"]))
        metrics = step(None, torch.Generator(), 1)
        model.d_module.load_state_dict(stats)
        return metrics, cap.grads, kept.fake.detach()

    train_fn_checks()
    (m_k, g_k, fake_k), counts, _ = counted(lambda: grad_step(g))
    check(counts == per_forward, f"one train step through the kernels: launches {counts} == {per_forward} "
          "(the forward's; the recompute backward launches none)")
    m_b, g_b, fake_b = grad_step(lambda x, zz: plain_forward(g, x, zz, torch.bfloat16))
    m_f, g_f, fake_f = grad_step(lambda x, zz: plain_forward(g, x, zz, torch.float32))
    check(all(math.isfinite(float(v)) for m in (m_k, m_b, m_f) for v in m.values()),
          "train step losses finite on the kernel, bf16 plain and f32 plain paths: l_g "
          f"{float(m_k['l_g']):.5f} / {float(m_b['l_g']):.5f} / {float(m_f['l_g']):.5f}")
    names = [n for n, _ in g.named_parameters()]
    worst, rows_k, rows_b = grad_band(names, g_k, g_b, g_f)
    # phase 11 holds the parallel steps' gradients and losses to these bands: twice the bf16 plain
    # path's distance from f32 plain (relative; absolute for the mean logits), at least a bf16 half-ulp
    launches["_grad_bands"] = {n: max(2 * rb, GRAD_BAND_FLOOR)
                               for n, rb in zip([n for n in names if n not in NOISE_GRADS], rows_b)}
    launches["_loss_bands"] = {
        k: max(2 * abs(float(m_b[k]) - float(v)) / (1.0 if k in ("D_real", "D_fake") else max(abs(float(v)), 1e-12)),
               GRAD_BAND_FLOOR) for k, v in m_f.items()}
    check(worst <= 1.0, f"G gradients through the kernels vs f32 plain: per-tensor relative L2 within twice the bf16 "
          f"plain path's (floor {GRAD_BAND_FLOOR:.3g}) for all {len(rows_k)} tensors: kernel median "
          f"{statistics.median(rows_k):.3g} max {max(rows_k):.3g}, bf16 plain median {statistics.median(rows_b):.3g} "
          f"max {max(rows_b):.3g}; worst ratio to the band {worst:.3f} (conv_last.bias, a float-noise gradient, "
          "not held); the step's fake: relative L2 to f32 plain "
          f"{rel_l2(fake_k, fake_f):.3g} (bf16 plain {rel_l2(fake_b, fake_f):.3g})")
    res = max_err(cem.downsample(fake_k), lr)
    check(res <= CEM_TOL, f"train step's own fake (kernel path): CEM residual max|H(fake) - lr| {res:.3g} <= {CEM_TOL}")
    # faults planted in the kernels' forward: what the step-level band sees
    for fault, (attr, stand_in, held) in planted_faults().items():
        orig = getattr(kernel_grads, attr)
        setattr(kernel_grads, attr, stand_in)
        try:
            _, g_x, fake_x = grad_step(g)
        finally:
            setattr(kernel_grads, attr, orig)
        w_x, rows_x, _ = grad_band(names, g_x, g_b, g_f)
        what = (f"G-gradient band on a train step whose {fault}: worst ratio to the band {w_x:.3f} "
                f"(relative L2 median {statistics.median(rows_x):.3g} max {max(rows_x):.3g}; the step's fake "
                f"{rel_l2(fake_x, fake_f):.3g} from f32 plain)")
        if held:
            check(w_x > 1.0, f"{what} > 1: the band fails it")
        else:
            print(f"note  {what}; not held: below bf16 rounding at G's initial weights, the Function check sees it",
                  flush=True)
        del g_x
    del g_b, g_f, g_k

    # timing: the kernel path against the bf16 plain autograd path, in turns
    g_opt, d_opt = model.g_opt, model.d_opt
    steps = {
        "kernels": make_gan_train_step(g, model.d_module, model.f_module, cem, lambda h, gen: batch,
                                       model.opt["train"], g_opt, d_opt, model.schedulers["G"],
                                       step_keyed(model.schedulers["D"])),
        "bf16 plain": make_gan_train_step(lambda x, zz: plain_forward(g, x, zz, torch.bfloat16), model.d_module,
                                          model.f_module, cem, lambda h, gen: batch, model.opt["train"], g_opt,
                                          d_opt, model.schedulers["G"], step_keyed(model.schedulers["D"])),
    }
    ms, peak = {k: [] for k in steps}, {k: [] for k in steps}
    n_steps = 5
    for name_ in ("bf16 plain", "kernels", "kernels", "bf16 plain"):
        step = steps[name_]
        step(None, torch.Generator(), 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(None, torch.Generator(), 2 + i)
        torch.cuda.synchronize()
        ms[name_].append((time.perf_counter() - t0) * 1e3 / n_steps)
        peak[name_].append(torch.cuda.max_memory_allocated() / 2**30)
    ms_step = {k: statistics.mean(v) for k, v in ms.items()}
    for name_ in steps:
        m = ms_step[name_]
        print(f"GAN train step B{B} x HR{TRAIN_HR} ({name_}): {m:.2f} ms/step "
              f"({', '.join(f'{v:.2f}' for v in ms[name_])}), {1e3 / m:.2f} steps/s, peak memory "
              f"{max(peak[name_]):.2f} GiB", flush=True)
    print(f"kernel path / bf16 plain path: {ms_step['kernels'] / ms_step['bf16 plain']:.3f} of the time per step",
          flush=True)

    # where a step's time goes: the device's busy share and its top operations
    from torch.profiler import ProfilerActivity, profile

    for name_, step in steps.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(2):
                step(None, torch.Generator(), 10 + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        # idle against the unprofiled step of the turns above: the profiler's
        # own per-operation cost stretches its wall, not the device's work
        print(f"profile, 2 GAN steps ({name_}): device busy {busy_ms / 2:.2f} ms per step, idle "
              f"{100 - 100 * busy_ms / 2 / ms_step[name_]:.1f}% of the unprofiled step ({ms_step[name_]:.2f} ms); "
              f"wall under the profiler {wall_ms / 2:.2f} ms per step; {sum(e.count for e in kernels) // 2} device "
              "ops per step", flush=True)
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
            t = e.self_device_time_total / 1e3
            print(f"  {t / 2:9.3f} ms/step {100 * t / busy_ms:5.1f}%  x{e.count // 2:<5d} {e.key[:90]}", flush=True)
        rdb = [e for e in kernels if "rdb5c" in e.key]
        if rdb:
            n = sum(e.count for e in rdb)
            per = sum(e.self_device_time_total for e in rdb) / 1e3 / max(n, 1)
            px = B * (TRAIN_HR // SCALE) ** 2
            flops = 2 * 9 * (sum((NF + k * GC) * GC for k in range(4)) + (NF + 4 * GC) * NF) * px
            b_ms, b_by = bound(flops, 2 * px * NF * 2)
            print(f"rdb5c at the train shape x (16,32,32,64) bf16 (64 tiles per launch): {per:.4f} ms per launch, "
                  f"bound {b_ms:.4f} ms ({b_by}), {n // 2} launches per step", flush=True)
            launches["_rdb5c_train_ms"] = {"ms": per, "bound_ms": b_ms, "bound_by": b_by}

    # the parts of a kernel-path step, CUDA events
    params = list(g.parameters())
    hr = batch["HR"]
    parts = {
        "G forward (kernels, layouts per call)": lambda: g(lr, z),
        "G forward + backward (kernels, recompute)": lambda: torch.autograd.grad(g(lr, z).mean(), params),
        "G forward + backward (bf16 plain)": lambda: torch.autograd.grad(
            plain_forward(g, lr, z, torch.bfloat16).mean(), params),
        "VGG19 on HR, and on SR forward + backward": lambda: _vgg_part(model.f_module, hr),
        "D forward + backward, doubled batch": lambda: torch.autograd.grad(
            model.d_module(torch.cat([hr, hr]), train=True).mean(), list(model.d_module.parameters())),
    }
    with torch.enable_grad():
        for what, fn in parts.items():
            print(f"train step part: {what}: {cuda_ms(fn, reps=3, warmup=1, windows=3):.2f} ms", flush=True)
    grads = [torch.zeros_like(p) for p in g_opt.params]
    dgrads = [torch.zeros_like(p) for p in d_opt.params]
    adam_ms = cuda_ms(lambda: (g_opt.step(grads, 0.0), d_opt.step(dgrads, 0.0)), reps=3, warmup=1, windows=3)
    print(f"train step part: Adam, G and D: {adam_ms:.2f} ms", flush=True)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.prepare_kernels()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        g.release_kernels()
    print(f"weight layouts of one G forward (69 rdb5c + 6 conv), built on the host's clock: "
          f"{statistics.median(times):.2f} ms (median of 5)", flush=True)
    return launches


def _vgg_part(f, hr: torch.Tensor):
    """VGG19 as the G loss runs it: on HR without grad, on SR (a leaf here)
    forward and backward."""
    with torch.no_grad():
        feat_hr = f(hr)
    sr = hr.detach().clone().requires_grad_(True)
    return torch.autograd.grad((f(sr.clamp(0, 1)) - feat_hr).abs().mean(), sr)


# -- phase 9: exploration ------------------------------------------------------

EXPLORE_LR = 128  # the LR image the editor explores
EXPLORE_BOX = (44, 44, 84, 84)  # a 40 x 40 LR selection: bucket 64, crop 256 HR
EXPLORE_DEVICE = "cuda"
EXPLORE_STEPS = 32  # Z steps per search round: the session's 64, halved to keep the script in half its time limit
LAYOUT_COUNTERS = (rdb_conv.LAYOUTS, kpack_conv.LAYOUTS)


class SearchLog:
    """Stands in front of a session's Z optimizer: keeps every search's loss
    trace (each tool click runs one or more searches). ``searching`` is set
    while a search runs: G's calls there are its Z steps, one each (a graph
    replay runs no Python, and the capture's call is none), so a forward hook
    counts only the calls outside (:meth:`hook`); ``rendering`` likewise
    while the session's render forward runs (a graph per image shape too:
    :meth:`count_renders` counts its calls)."""

    def __init__(self, inner):
        self.inner, self.traces, self.searching, self.rendering = inner, [], False, False

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *a, **kw):
        self.searching = True
        try:
            z, losses = self.inner(*a, **kw)
        finally:
            self.searching = False
        self.traces.append(np.asarray(losses))
        return z, losses

    def hook(self, g, forwards: list):
        """Count ``g``'s calls outside the searches and the renders in ``forwards[0]``."""
        def count(*_):
            if not (self.searching or self.rendering):
                forwards[0] += 1

        return g.register_forward_hook(count)

    def count_renders(self, sess, renders: list) -> None:
        """Count the session's render calls (one G call each) in ``renders[0]``."""
        render = sess._render

        def counted_render(lr, z):
            renders[0] += 1
            self.rendering = True
            try:
                return render(lr, z)
            finally:
                self.rendering = False

        sess._render = counted_render


def explore_session(tmp: Path, pth: str):
    """The flagship editor as the CLI builds it: G from ``pth``, CEM, and a D
    (``define_D(seed=0)``, nf 64, BatchNorm, trained input 128) from its own
    ``.pth``, on an LR 128 x 128 PNG written by the port's codec."""
    d_opt = {"network_D": {"nf": NF, "norm_type": "batch"}, "datasets": {"train": {"HR_size": 128}}, "bf16": True}
    d_pth = tmp / "D.pth"
    torch.save(define_D(d_opt, device=EXPLORE_DEVICE, seed=0).state_dict(), d_pth)
    lr_png = tmp / "explore_lr.png"
    img = SyntheticDataset({"phase": "test", "image_size": EXPLORE_LR})._make_image(11)
    save_img((img * 255.0).round().astype(np.uint8), str(lr_png))
    opt = flagship_options(tmp, pth, "explore", {})
    opt["path"]["pretrain_model_D"] = str(d_pth)
    opt_path = tmp / "explore.json"
    opt_path.write_text(json.dumps(opt))
    t0 = time.perf_counter()
    sess = explore_cli.build_session_from_opt(str(opt_path), str(lr_png), device=EXPLORE_DEVICE)
    print(f"explore: session built through the CLI's build_session_from_opt in {time.perf_counter() - t0:.2f} s "
          f"(G, CEM, D from .pth; layouts built once)", flush=True)
    return sess


def explore_clicks(sess) -> tuple[list[tuple[str, object]], np.ndarray]:
    """The editor's tools, one click each (``EXPLORE_STEPS`` a round), and the
    imprint click's target."""
    sr = sess.current_sr()[0]
    y0, x0, y1, x1 = (v * SCALE for v in EXPLORE_BOX)
    alpha = explore_vm.render_text_mask("ESR", (y1 - y0, x1 - x0))[..., None]
    # an image imprinted over the selection (white text on mid gray): the
    # editor's text tool composites over the SR itself, where |sr - target|
    # is 0 outside the glyphs and JAX's |.| gradient at 0 (1) pushes Z there too
    target = sr.copy()
    target[y0:y1, x0:x1] = 0.5 * (1 - alpha) + alpha
    patch = np.random.default_rng(12).random((48, 48, 3)).astype(np.float32) ** 2

    def alternatives():
        cands = sess.propose_alternatives(k=2, seed=0)
        sess.apply_alternative(cands[1][0])

    return [
        ("imprint (adaptive)", lambda: sess.imprint(target)),
        ("variance +", sess.increase_variance),
        ("variance -", sess.decrease_variance),
        ("brightness 0.7", lambda: sess.brightness(0.7)),
        ("smooth", sess.smooth),
        ("periodicity 0 8", lambda: sess.periodicity(0.0, 8.0)),
        ("histogram", lambda: sess.match_histogram(patch, adaptive=False)),
        ("realism +", lambda: sess.realism(1.0)),
        ("alternatives k=2, apply one", alternatives),
    ], target


def phase_explore(tmp: Path, pth: str) -> dict[str, int]:
    """Exploration at full width on the card: every tool click through the
    kernels on the layouts built once; returns the launches of the clicks."""
    sess = explore_session(tmp, pth)
    sess.set_search_strength(n_steps=EXPLORE_STEPS)
    g, cem = sess.g, sess.cem
    lr = torch.from_numpy(sess.lr_img).to(sess.device)
    check(sess._d is not None and not any(p.requires_grad for p in g.parameters()),
          "explore: D attached for the realism tool, G frozen")
    log = SearchLog(sess._optimizer)
    sess._optimizer = log
    forwards, renders = [0], [0]
    hook = log.hook(g, forwards)
    render = sess._render
    log.count_renders(sess, renders)
    clicks, text_target = explore_clicks(sess)
    y0, x0, y1, x1 = (v * SCALE for v in EXPLORE_BOX)
    sess.select_rect(y0, x0, y1, x1)
    check(sess._box_lr == EXPLORE_BOX and bucket_crop(EXPLORE_BOX, EXPLORE_LR, EXPLORE_LR, SCALE)[2] == 64,
          f"explore: selection {sess._box_lr} LR, bucket 64 (crop 256 HR)")

    def full_image_smooth():
        sess._mask, sess._box_lr = None, None  # no selection: the whole 128 x 128
        return sess.smooth()

    clicks.append(("smooth, no selection (full 128x128)", full_image_smooth))
    # the main path: every click, counts set to 0 just before and read just after
    for c in COUNTERS:
        c.reset()
    forwards[0] = renders[0] = 0
    layouts0 = [c.count for c in LAYOUT_COUNTERS]
    timings = []
    for what, click in clicks:
        sr_before = sess.current_sr().copy()
        n_traces, fwd0 = len(log.traces), forwards[0]
        builds0 = [c.count for c in LAYOUT_COUNTERS]
        t0 = time.perf_counter()
        click()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        traces = log.traces[n_traces:]
        steps = sum(len(t) for t in traces)
        builds = [c.count - b for c, b in zip(LAYOUT_COUNTERS, builds0)]
        rounds = sess.last_rounds if "adaptive" in what else None
        if rounds:
            # better than the start, or stopped as insensitive at full escalation
            down = (rounds[-1]["best"] < rounds[0]["first"]
                    or rounds[-1].get("stop") == "insensitive-at-max-escalation")
            lrs = "->".join(format(r["lr"], "g") for r in rounds)
            how = (f"adaptive: {len(rounds)} rounds, lr {lrs}, z-range "
                   f"{rounds[-1]['z_range']:g}, stop {rounds[-1].get('stop')}, best {rounds[-1]['best']:.5f} "
                   f"from {rounds[0]['first']:.5f}")
        else:
            down = all(t[-1] < t[0] for t in traces)
            how = "loss " + ", ".join(f"{t[0]:.5f} -> {t[-1]:.5f}" for t in traces)
        sr = sess.current_sr()
        res = max_err(cem.downsample(torch.from_numpy(sr).to(lr.device)), lr)
        sess.undo()
        restored = np.array_equal(sess.current_sr(), sr_before)
        sess.redo()
        check(down and res <= CEM_TOL and restored and builds == [0, 0] and steps > 0,
              f"explore click {what}: {how}; {steps} Z steps in {secs * 1e3:.1f} ms ({secs * 1e3 / steps:.2f} ms per "
              f"step); CEM residual {res:.3g} <= {CEM_TOL}; undo restores the SR bit for bit {restored}; layouts "
              f"built {builds}")
        timings.append((what, secs, steps))
    torch.cuda.synchronize()
    counts = {c.name: c.count for c in COUNTERS}
    total_steps = sum(s for _, _, s in timings)
    n_fwd = forwards[0] + renders[0] + total_steps
    hook.remove()
    sess._render = render
    want = {k: v * n_fwd for k, v in EXPECTED_PER_FORWARD.items()}
    check(counts == want and [c.count for c in LAYOUT_COUNTERS] == layouts0,
          f"explore, {len(clicks)} clicks ({total_steps} Z steps, {n_fwd} G calls with the {renders[0]} SR renders): launches "
          f"{counts} == {want}, so none in any backward; layouts built during the clicks "
          f"{[c.count - b for c, b in zip(LAYOUT_COUNTERS, layouts0)]}")
    secs = sum(t for _, t, _ in timings)
    print(f"explore clicks: {secs:.2f} s for {total_steps} Z steps, {secs * 1e3 / total_steps:.2f} ms per Z step "
          f"on average (search, crop and paste, SR render and history included)", flush=True)
    # the render: its own forward, a CUDA graph of the image's shape, against the session's forward eagerly
    zt = torch.from_numpy(sess.z).to(lr.device)
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            same = torch.equal(render(lr, zt), sess.forward(lr, zt))
        render_ms = cuda_ms(lambda: render(lr, zt), reps=5, warmup=1, windows=3)
        with torch.no_grad():
            eager_ms = cuda_ms(lambda: sess.forward(lr, zt), reps=5, warmup=1, windows=3)
    finally:
        torch.backends.cudnn.deterministic = False
    check(same and len(render.graphs.steps) == 1 and render is not sess.forward,
          f"explore render, LR {EXPLORE_LR}x{EXPLORE_LR} (the session's Z): its graph == the session's forward "
          f"eagerly, bit for bit {same}; {len(render.graphs.steps)} graph; {render_ms:.3f} ms as a graph, "
          f"{eager_ms:.3f} ms eagerly (CUDA events, CEM included)")

    # one Z step on the crop, by hand: the launches of its forward and backward
    y, x, size = bucket_crop(EXPLORE_BOX, EXPLORE_LR, EXPLORE_LR, SCALE)
    lr_c = lr[:, y : y + size, x : x + size].contiguous()
    mask = torch.zeros(size * SCALE, size * SCALE, device=lr.device)
    mask[(EXPLORE_BOX[0] - y) * SCALE : (EXPLORE_BOX[2] - y) * SCALE,
         (EXPLORE_BOX[1] - x) * SCALE : (EXPLORE_BOX[3] - x) * SCALE] = 1.0
    z_fixed = torch.from_numpy(np.random.default_rng(14).uniform(-0.5, 0.5, (1, size, size, NZ))
                               .astype(np.float32)).to(lr.device)

    def plain_path(dtype):
        return lambda lr_, z_: cem.project(plain_forward(g, lr_, z_, dtype), lr_)

    with torch.no_grad():
        sr_f = plain_path(torch.float32)(lr_c, z_fixed)[0]
    # imprint targets: 0.2-0.4 above the f32 SR at the fixed Z (|sr - target|
    # keeps its sign on every path), and the imprint click's own, cropped
    rng = np.random.default_rng(13)
    targets = {"0.2-0.4 above the SR": sr_f + torch.from_numpy(
                   rng.uniform(0.2, 0.4, tuple(sr_f.shape)).astype(np.float32)).to(lr.device),
               "the imprint click's": torch.from_numpy(np.ascontiguousarray(
                   text_target[y * SCALE : (y + size) * SCALE, x * SCALE : (x + size) * SCALE])).to(lr.device)}
    objective = explore_obj.imprint_objective(targets["0.2-0.4 above the SR"]).to(lr.device)

    def dloss_dz(forward, obj=objective):
        zl = z_fixed.clone().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(obj(forward(lr_c, zl), mask), zl)[0]

    for c in COUNTERS:
        c.reset()
    zl = z_fixed.clone().requires_grad_(True)
    builds0 = [c.count for c in LAYOUT_COUNTERS]
    with torch.enable_grad():
        loss = objective(sess.forward(lr_c, zl), mask)
        torch.cuda.synchronize()
        fwd = {c.name: c.count for c in COUNTERS}
        for c in COUNTERS:
            c.reset()
        torch.autograd.grad(loss, zl)
        torch.cuda.synchronize()
    bwd = {c.name: c.count for c in COUNTERS}
    builds = [c.count - b for c, b in zip(LAYOUT_COUNTERS, builds0)]
    check(fwd == EXPECTED_PER_FORWARD and not any(bwd.values()) and builds == [0, 0],
          f"explore: one Z step on the 64x64 LR crop launches {fwd} forward (== {EXPECTED_PER_FORWARD}), {bwd} in "
          f"the backward, builds {builds} layouts")

    # dloss/dZ through the kernels against the plain paths, and a planted
    # fault: an RDB kernel that returns its input
    for i, (what, tgt) in enumerate(targets.items()):
        obj = explore_obj.imprint_objective(tgt).to(lr.device)
        dz_k, dz_b, dz_f = (dloss_dz(f, obj) for f in (sess.forward, plain_path(torch.bfloat16),
                                                      plain_path(torch.float32)))
        r_k, r_b = rel_l2(dz_k, dz_f), rel_l2(dz_b, dz_f)
        band = max(2 * r_b, GRAD_BAND_FLOOR)
        check(r_k <= band, f"explore dloss/dZ (imprint target {what}, fixed Z, 64x64 LR crop) through the kernels: "
              f"relative L2 {r_k:.4g} to the f32 plain path <= {band:.4g} (twice the bf16 plain path's {r_b:.4g}, "
              f"floor {GRAD_BAND_FLOOR:.3g})")
        orig = kernel_grads.rdb5c_launch
        kernel_grads.rdb5c_launch = lambda x_, kw, *a, **k: x_.clone()
        try:
            r_x = rel_l2(dloss_dz(sess.forward, obj), dz_f)
        finally:
            kernel_grads.rdb5c_launch = orig
        what_x = (f"explore dloss/dZ band (imprint target {what}) on a planted RDB kernel that returns its input: "
                  f"relative L2 {r_x:.4g}, band {band:.4g}")
        if i == 0:
            check(r_x > band, f"{what_x}: the band fails it")
        else:
            print(f"note  {what_x} ({'outside' if r_x > band else 'inside'} it; held on the first target only: "
                  "where the L1 changes sign pixel by pixel, bf16 rounding moves dZ by more)", flush=True)

    # ms per Z step: the kernel path against the bf16 plain autograd path, in
    # turns, the same search (imprint, 8 steps, the crop)
    paths = {"kernels": sess.forward, "bf16 plain": plain_path(torch.bfloat16)}
    caches = {k: ZSearchCache() for k in paths}  # each path's search captured once, by its warm-up call
    n_steps = 8
    ms = {k: [] for k in paths}
    for name in ("bf16 plain", "kernels", "kernels", "bf16 plain"):
        optimize_z(paths[name], lr_c, z_fixed, mask, objective, n_steps=2, cache=caches[name])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_z(paths[name], lr_c, z_fixed, mask, objective, n_steps=n_steps, cache=caches[name])
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / n_steps)
    ms_step = {k: statistics.mean(v) for k, v in ms.items()}
    for name, m in ms_step.items():
        print(f"explore Z step, 64x64 LR crop (HR 256), imprint ({name}, CUDA graph replays): {m:.2f} ms per step "
              f"({', '.join(f'{v:.2f}' for v in ms[name])})", flush=True)
    print(f"explore: kernel path / bf16 plain path: {ms_step['kernels'] / ms_step['bf16 plain']:.3f} of the time per "
          "Z step", flush=True)
    for what, secs, steps in timings:
        print(f"  click {what:<38s} {secs * 1e3:9.1f} ms, {steps:4d} Z steps, {secs * 1e3 / steps:7.2f} ms per step",
              flush=True)

    # where a Z step's time goes: the device's busy share and its top operations
    from torch.profiler import ProfilerActivity, profile

    for name, fwd_fn in paths.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            optimize_z(fwd_fn, lr_c, z_fixed, mask, objective, n_steps=4, cache=caches[name])
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 4
        print(f"profile, 4 Z steps ({name}): device busy {busy:.2f} ms per step, idle "
              f"{100 - 100 * busy / ms_step[name]:.1f}% of the unprofiled step ({ms_step[name]:.2f} ms); host time "
              f"outside the device {ms_step[name] - busy:.2f} ms per step; {sum(e.count for e in kernels) // 4} "
              "device ops per step", flush=True)
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
            t = e.self_device_time_total / 1e3
            print(f"  {t / 4:9.3f} ms/step {100 * t / 4 / max(busy, 1e-9):5.1f}%  x{e.count // 4:<5d} {e.key[:90]}",
                  flush=True)
    with torch.enable_grad():
        for what, fn in (("G + CEM forward, Z needs grad (kernels)", lambda: sess.forward(lr_c, zl)),
                         ("forward + backward to dZ (kernels, recompute)", lambda: dloss_dz(sess.forward)),
                         ("forward + backward to dZ (bf16 plain)", lambda: dloss_dz(paths["bf16 plain"]))):
            print(f"explore Z step part: {what}: {cuda_ms(fn, reps=3, warmup=1, windows=3):.2f} ms (CUDA events)",
                  flush=True)
    return counts


# -- phase 10: blind SR and the generator variants -----------------------------

BLIND_LR = 96  # blind_bench's larger LR: 1/f HR 384 images, their Gaussian LR
BLIND_ITERS = 200  # the estimator iterations of the blind CLIs' runs
BENCH_ITERS = 2000  # blind_bench's adversarial estimate
KG_ITERS = 250  # KernelGAN graph against eager: two chunks and a ragged last one
BLIND_DEVICE = "cuda"
ZERO_BY_DESIGN = {p: ("rdb5c", "upsample2x_conv3x3") for p in ("srresnet", "srresnet_train")}
F32_SIMT = (rdb_conv.LAUNCHES_SIMT["f32"], kpack_conv.LAUNCHES_SIMT[(3, "f32")],
            kpack_conv.LAUNCHES_SIMT[(2, "f32")], kpack_conv.LAUNCHES_F32)


def kernel_tuple(k) -> tuple:
    return tuple(map(tuple, np.asarray(k, np.float64)))


def cem_tol(kernel) -> float:
    """The CEM residual's f32 limit under ``kernel``: the rounding of a
    correlation grows with sum |k|, 1 for a nonnegative unit-sum kernel and
    ~11 for a sign-mixed 200-iteration estimate."""
    return CEM_TOL * max(1.0, float(np.abs(np.asarray(kernel, np.float64)).sum()))


def blind_lr(seed: int, k_true) -> tuple[np.ndarray, np.ndarray]:
    """A 1/f HR 384 image and its LR 96 under the true kernel (H on the card)."""
    hr = blind_bench.one_f_image(BLIND_LR * SCALE, BLIND_LR * SCALE, seed)
    cem = make_cem(CEMConf(scale=SCALE, kernel=kernel_tuple(k_true)), device=BLIND_DEVICE)
    with torch.no_grad():
        lr = cem.downsample(torch.from_numpy(hr)[None].to(BLIND_DEVICE)).clamp(0.0, 1.0)[0].cpu().numpy()
    return hr, lr


@torch.no_grad()
def blind_cem_checks() -> None:
    """(a) CEM's fft and filter modes in f32 on B4 x LR 128 random G outputs
    (HR 512), under the anisotropic Gaussian and the MATLAB-bicubic 2-D
    kernel, with cuDNN's TF32 at its global default (on): TF32 is off inside
    CEM's convs. ms per ``project`` at B16 x LR 128."""
    torch.backends.cudnn.allow_tf32 = True  # the global default
    try:
        gen_ = torch.Generator(BLIND_DEVICE).manual_seed(40)
        raw = torch.rand(4, 4 * LR, 4 * LR, 3, device=BLIND_DEVICE, generator=gen_) * 3 - 1
        lr = torch.rand(4, LR, LR, 3, device=BLIND_DEVICE, generator=gen_)
        kernels = {"aniso Gaussian 13x13": blind_bench.gaussian_kernel(),
                   "bicubic 2-D 16x16": downsample_kernel_2d(SCALE)[0]}
        cems = {}
        for name, k in kernels.items():
            cem = cems[name] = make_cem(CEMConf(scale=SCALE, kernel=kernel_tuple(k)), device=BLIND_DEVICE)
            res = max_err(cem.downsample(cem.project(raw, lr)), lr)
            ref64 = make_cem(CEMConf(scale=SCALE, kernel=kernel_tuple(k)), device="cpu").downsample(
                raw[:1].double().cpu())
            e64 = max_err(cem.downsample(raw[:1]).cpu(), ref64)
            x, y = raw[:1].double(), lr[:1].double()
            a = float((cem.downsample(x) * y).sum())
            b = float((x * cem.upsample_transpose(y, x.shape)).sum())
            check(cem._mode == "fft" and res <= CEM_TOL and e64 <= 1e-5 and abs(a - b) <= 1e-9 * abs(a),
                  f"CEM fft, {name}, B4 x LR 128, cuDNN TF32 default on: residual max|H(project) - lr| {res:.3g} <= "
                  f"{CEM_TOL}; H against f64 {e64:.3g} <= 1e-5 (no TF32); <Hx,y> - <x,H^T y> {abs(a - b):.3g} "
                  f"of {abs(a):.4g} (f64)")
        cem_m = make_cem(CEMConf(scale=SCALE), device=BLIND_DEVICE)
        cem_f = make_cem(CEMConf(scale=SCALE, inv_mode="fft"), device=BLIND_DEVICE)
        e = max(max_err(cem_m.project(raw, lr), cem_f.project(raw, lr)),
                max_err(cem_m.dt_satisfying_upscale(lr), cem_f.dt_satisfying_upscale(lr)))
        check(e <= 2e-4, f"CEM bicubic: fft mode == matmul mode, project and H^+: max diff {e:.3g} <= 2e-4")
        for name, k in kernels.items():
            cem33 = make_cem(CEMConf(scale=SCALE, kernel=kernel_tuple(k), inv_mode="filter", inv_filter_support=33),
                             device=BLIND_DEVICE)
            res33 = max_err(cem33.downsample(cem33.project(raw, lr)), lr)
            check(res33 < 2e-3, f"CEM filter mode, support 33, {name}: residual {res33:.3g} < 2e-3")
        raw16 = torch.rand(B, 4 * LR, 4 * LR, 3, device=BLIND_DEVICE, generator=gen_)
        lr16 = torch.rand(B, LR, LR, 3, device=BLIND_DEVICE, generator=gen_)
        for name, cem in (("bicubic matmul", cem_m), ("bicubic fft", cem_f),
                          ("aniso Gaussian fft", cems["aniso Gaussian 13x13"]),
                          ("bicubic filter 33", make_cem(CEMConf(scale=SCALE, inv_mode="filter",
                                                                 inv_filter_support=33), device=BLIND_DEVICE))):
            print(f"CEM project B{B} x LR {LR} (HR {4 * LR}), {name}: "
                  f"{cuda_ms(lambda c=cem: c.project(raw16, lr16), reps=5, warmup=2, windows=3):.3f} ms", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def kernelgan_checks(tmp: Path, card: str) -> tuple[np.ndarray, dict]:
    """(b) KernelGAN on the card: the effective-kernel identity, the
    supervised probe, the adversarial estimate through ``blind_bench``, the
    iteration as a CUDA graph against the eager loop (both steps), and where
    an iteration's time goes. Returns the LR 96 image and the bench row."""
    conf = kernelgan.KernelGANConf()
    g = kernelgan.LinearKernelG(conf, seed=3).to(BLIND_DEVICE)
    x = torch.rand(1, BLIND_LR, BLIND_LR, 1, device=BLIND_DEVICE, generator=torch.Generator(BLIND_DEVICE).manual_seed(3))
    with torch.no_grad(), full_f32():
        k = kernelgan.effective_kernel(g, conf)
        flat = g(x, stride=False)
        e = max_err(flat, F.conv2d(x.permute(0, 3, 1, 2), k[None, None]).permute(0, 2, 3, 1))
        strided = torch.equal(g(x), flat[:, ::SCALE, ::SCALE])
    check(tuple(k.shape) == (21, 21) and e <= 1e-5 and strided,
          f"KernelGAN effective kernel (21x21) on the card: G(x) vs one VALID correlation max err {e:.3g} <= 1e-5; "
          f"strided G == its ::4 subsample {strided}")

    k_true = blind_bench.gaussian_kernel()
    kt = torch.tensor(k_true, dtype=torch.float32, device=BLIND_DEVICE)[None, None]

    def loss_override(fake, g_in):  # tests/test_kernelgan.py's oracle: centred SAME conv on G's phase
        full = F.conv2d(g_in.permute(0, 3, 1, 2), kt, padding=6).permute(0, 2, 3, 1)
        return torch.mean((fake - full[:, 6::4, 6::4][:, : fake.shape[1], : fake.shape[2]]) ** 2)

    probe = kernelgan.KernelGANConf(scale=4, g_kernels=(7, 5, 3, 1), g_channels=16, d_kernels=(5, 1, 1),
                                    d_channels=16, g_input=32, iters=1000, lr_g=2e-3, w_centralized=0.1,
                                    w_boundaries=0.1)
    img = np.random.default_rng(2).random((96, 96)).astype(np.float32)
    t0 = time.perf_counter()
    k_est, m = kernelgan.estimate_kernel(img, probe, loss_override=loss_override, device=BLIND_DEVICE)
    secs = time.perf_counter() - t0
    k_again, _ = kernelgan.estimate_kernel(img, probe, loss_override=loss_override, device=BLIND_DEVICE)
    corr = blind_bench.aligned_corr(k_est, k_true)
    check(corr > 0.88 and abs(k_est.sum() - 1) < 1e-6 and np.array_equal(k_est, k_again),
          f"KernelGAN supervised probe (tests/test_kernelgan.py's conf, 1000 iterations, cuDNN deterministic): "
          f"aligned corr {corr:.4f} > 0.88, unit sum; a second run gives the same kernel bit for bit "
          f"{np.array_equal(k_est, k_again)}; {secs:.2f} s ({secs:.3f} ms per iteration x 1000), l_g {m['l_g']:.5f}")

    # the adversarial estimator as blind_bench runs it (G nf 16 / nb 2 / gc 8 in f32: the f32 route, conv_f32_kernel)
    row, counts, secs = counted(lambda: blind_bench.run_case("aniso_gauss", k_true, BLIND_LR, BENCH_ITERS, seed=0,
                                                             device=BLIND_DEVICE), F32_SIMT)
    fin = all(math.isfinite(row[f"{p}_{lab}"]) for p in ("psnr", "true_res") for lab in ("est", "true", "bicubic"))
    check(fin and row["self_res_true"] <= CEM_TOL and row["self_res_bicubic"] <= CEM_TOL
          and row["true_res_true"] <= CEM_TOL and all(counts.values()),
          f"blind_bench aniso_gauss LR {BLIND_LR}, {BENCH_ITERS} iterations (adversarial): corr {row['corr']:.4f}; PSNR "
          f"est/true/bicubic {row['psnr_est']:.2f}/{row['psnr_true']:.2f}/{row['psnr_bicubic']:.2f} dB; true-operator "
          f"residual est/true/bicubic {row['true_res_est']:.3g}/{row['true_res_true']:.3g}/{row['true_res_bicubic']:.3g};"
          f" self residual est {row['self_res_est']:.3g}; estimate {row['estimate_s']:.2f} s "
          f"({row['estimate_s'] * 1e3 / BENCH_ITERS:.3f} ms per iteration); f32 route launches {counts}")
    # the iteration as a CUDA graph (one capture, then a replay an iteration) against the same loop eagerly,
    # cuDNN deterministic: both steps over 250 iterations (chunks of 100, 100 and 50), bit for bit
    _, lr96 = blind_lr(0, k_true)
    adv250 = kernelgan.conf_for_image(lr96.shape, SCALE, KG_ITERS)
    sup250 = kernelgan.KernelGANConf(**{**probe.__dict__, "iters": KG_ITERS})
    torch.backends.cudnn.deterministic = True
    try:
        for what, conf, image, loss in (("adversarial", adv250, lr96, None), ("supervised", sup250, img, loss_override)):
            runs = []
            for graphed in (True, False):
                calls = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.nullcontext() if graphed else eager_steps():
                    k_, m_ = kernelgan.estimate_kernel(image, conf, progress=lambda *a: calls.append(a),  # noqa: B023
                                                       loss_override=loss, device=BLIND_DEVICE)
                runs.append((k_, m_, calls, time.perf_counter() - t0))
            (k_g, m_g, c_g, s_g), (k_e, m_e, c_e, s_e) = runs
            check(np.array_equal(k_g, k_e) and m_g == m_e and c_g == c_e and [c[0] for c in c_g] == [100, 200, 250],
                  f"KernelGAN {what} step, {KG_ITERS} iterations (chunks of 100, 100, 50), cuDNN deterministic: the "
                  f"iteration's CUDA graph (1 capture, {KG_ITERS - 1} replays) == the eager loop, kernel and every "
                  f"chunk's metrics bit for bit (l_g {m_g['l_g']:.6f}); {s_g:.2f} s against {s_e:.2f} s")
    finally:
        torch.backends.cudnn.deterministic = False

    # ms per iteration in turns (graph, eager, eager, graph): a 300-iteration estimate's progress calls (each
    # after its chunk's one read from the device) 200 iterations apart, so no set-up and no capture; KernelGAN
    # has no bf16 plain path (its G and D are f32 F.conv2d) to time beside them
    def ms_per_iteration(graphed: bool) -> float:
        stamps = {}
        with contextlib.nullcontext() if graphed else eager_steps():
            kernelgan.estimate_kernel(lr96, kernelgan.conf_for_image(lr96.shape, SCALE, 300), device=BLIND_DEVICE,
                                      progress=lambda done, *_: stamps.setdefault(done, time.perf_counter()))
        return (stamps[300] - stamps[100]) * 1e3 / 200

    turns = {"graph": [], "eager": []}
    for name in ("graph", "eager", "eager", "graph"):
        turns[name].append(ms_per_iteration(name == "graph"))
    ms = {k: statistics.mean(v) for k, v in turns.items()}
    # where a graphed iteration's time goes: a 300-iteration estimate under the profiler (1 warm-up, 1 capture,
    # 299 replays), its device busy time per iteration against the unprofiled iteration's time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernelgan.estimate_kernel(lr96, kernelgan.conf_for_image(lr96.shape, SCALE, 300), device=BLIND_DEVICE)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ops) / 1e3 / 300
    print(f"KernelGAN iteration (default conf, g_input 64, LR {BLIND_LR}) on {card}: graph {ms['graph']:.3f} ms "
          f"({', '.join(f'{v:.3f}' for v in turns['graph'])}), eager {ms['eager']:.3f} ms "
          f"({', '.join(f'{v:.3f}' for v in turns['eager'])}), graph / eager {ms['graph'] / ms['eager']:.3f}; no bf16 "
          f"plain path (f32 F.conv2d throughout); graphed: device busy {busy:.3f} ms an iteration, idle "
          f"{100 - 100 * busy / ms['graph']:.1f}% of the graph's iteration; {sum(e.count for e in ops) // 300} device "
          "events an iteration", flush=True)
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:5]:
        print(f"  {e.self_device_time_total / 1e3 / 300:9.4f} ms/iter x{e.count:<5d} {e.key[:90]}", flush=True)
    return lr96, row


def blind_cli_checks(tmp: Path, lr96: np.ndarray) -> str:
    """(c) ``scripts.estimate_kernel`` at 200 iterations on the LR 96 PNG;
    returns the PNG's path."""
    png_path = tmp / "blind_lr.png"
    save_img(tensor2img(lr96), str(png_path))
    out = tmp / "kernel_x4.npy"
    t0 = time.perf_counter()
    estimate_kernel_cli.main(["--lr", str(png_path), "--iters", str(BLIND_ITERS), "--out", str(out),
                              "--watchdog", "0", "--device", BLIND_DEVICE])
    secs = time.perf_counter() - t0
    k = np.load(out)
    loaded = np.asarray(resolve_kernel(str(out)))
    check(k.shape == (21, 21) and abs(k.sum() - 1) < 1e-6 and loaded.shape == (21, 21),
          f"estimate_kernel CLI, {BLIND_ITERS} iterations on the LR {BLIND_LR} PNG: a unit-sum 21x21 .npy that "
          f"resolve_kernel loads; {secs:.2f} s")
    return str(png_path)


def true_residual(cem_true, res_dir: Path, lr_dir: Path) -> float:
    worst = 0.0
    for f in sorted(lr_dir.iterdir()):
        sr = torch.from_numpy(read_img(str(res_dir / f.name)))[None].to(BLIND_DEVICE)
        lr = torch.from_numpy(read_img(str(f)))[None].to(BLIND_DEVICE)
        worst = max(worst, max_err(cem_true.downsample(sr), lr))
    return worst


def blind_eval_checks(tmp: Path, pth: str) -> dict:
    """(d) Blind eval through ``test.main --estimate_kernel 200`` at the
    flagship width on an LRHR folder (two 1/f HR 384 images, their Gaussian
    LR), beside the run without the flag. The wiring's check, as
    tests/test_torch_blind.py makes it: G's output zeroed (SR = the CEM
    low-frequency term, so no clipping hides the operator), the estimator
    returning the true kernel, against the same G without the flag. Returns
    the launches of the estimated run."""
    k_true = blind_bench.gaussian_kernel()
    hr_dir, lr_dir = tmp / "blind_hr", tmp / "blind_lr"
    for i in range(2):
        hr, lr = blind_lr(10 + i, k_true)
        save_img(tensor2img(hr), str(hr_dir / f"img{i}.png"))
        save_img(tensor2img(lr), str(lr_dir / f"img{i}.png"))
    zero_pth = str(tmp / "G_zero_out.pth")
    sd = torch.load(pth)
    torch.save({k: torch.zeros_like(v) if k.startswith("conv_last.") else v for k, v in sd.items()}, zero_pth)
    cem_true = make_cem(CEMConf(scale=SCALE, kernel=kernel_tuple(k_true)), device=BLIND_DEVICE)
    ds = {"test_1": {"name": "blind", "mode": "LRHR", "dataroot_HR": str(hr_dir), "dataroot_LR": str(lr_dir)}}
    runs = {}
    est = ["--estimate_kernel", str(BLIND_ITERS)]
    for label, g_path, flags in (("estimated", pth, est), ("no flag", pth, []),
                                 ("true kernel, G zeroed", zero_pth, est), ("no flag, G zeroed", zero_pth, [])):
        opt = flagship_options(tmp, g_path, "blind_" + label.replace(" ", "_").replace(",", ""), ds, num_random_Z=0)
        orig, used = kernelgan.estimate_kernel, [None]

        def estimate(*a, **kw):  # records the kernel the model is built under
            k, m = (k_true.copy(), {"l_g": 0.0}) if label.startswith("true kernel") else orig(*a, **kw)
            used[0] = k
            return k, m

        kernelgan.estimate_kernel = estimate
        try:
            res, counts, secs = run_cli(tmp, opt, "--save_images", "--device", BLIND_DEVICE, *flags)
        finally:
            kernelgan.estimate_kernel = orig
        tres = true_residual(cem_true, tmp / "results" / opt["name"] / "blind", lr_dir)
        runs[label] = (res["blind"], counts, secs, tres)
        tol = cem_tol(1.0 if used[0] is None else used[0])
        check(counts == {k: 2 * v for k, v in EXPECTED_PER_FORWARD.items()} and res["blind"]["cem_residual"] <= tol,
              f"blind eval ({label}, flagship, 2 x LR {BLIND_LR}): launches {counts} (2 forwards); CEM residual under "
              f"its kernel {res['blind']['cem_residual']:.3g} <= {tol:.3g}; SR true-operator residual {tres:.3g}; "
              f"PSNR {res['blind']['psnr']:.2f} dB; {secs:.2f} s ({secs * 1e3 / 2:.1f} ms per image, the estimate "
              "included)")
    t_est, t_off, t_true, t_off0 = (runs[k][3] for k in runs)
    check(t_true < 5e-3 and t_off0 > 10 * t_true,
          f"blind eval, G zeroed, the estimator returning the true kernel: true-operator residual {t_true:.3g} < 5e-3, "
          f"the bicubic assumption's {t_off0:.3g} > 10x that")
    print(f"note  blind eval with the {BLIND_ITERS}-iteration estimate: true-operator residual {t_est:.3g} against "
          f"{t_off:.3g} without the flag ({'lower' if t_est < t_off else 'not lower'})", flush=True)
    return runs["estimated"][1]


def blind_explore_checks(tmp: Path, pth: str, lr_png: str) -> dict:
    """(e) The explorer's session with ``estimate_kernel_iters`` 200 on the
    LR 96 PNG, then one 64-step smooth click through the kernels."""
    opt = flagship_options(tmp, pth, "blind_explore", {})
    opt_path = tmp / "blind_explore.json"
    opt_path.write_text(json.dumps(opt))
    t0 = time.perf_counter()
    sess = explore_cli.build_session_from_opt(str(opt_path), lr_png, estimate_kernel_iters=BLIND_ITERS,
                                              device=BLIND_DEVICE)
    built = time.perf_counter() - t0
    log = SearchLog(sess._optimizer)
    sess._optimizer = log
    forwards = [0]
    hook = log.hook(sess.g, forwards)
    sess.select_rect(28 * SCALE, 28 * SCALE, 68 * SCALE, 68 * SCALE)
    lr = torch.from_numpy(sess.lr_img).to(BLIND_DEVICE)
    sr_before = sess.current_sr().copy()
    builds0 = [c.count for c in LAYOUT_COUNTERS]
    forwards[0] = 0
    _, counts, secs = counted(sess.smooth)
    hook.remove()
    builds = [c.count - b for c, b in zip(LAYOUT_COUNTERS, builds0)]
    trace = log.traces[-1]
    res = max_err(sess.cem.downsample(torch.from_numpy(sess.current_sr()).to(BLIND_DEVICE)), lr)
    sess.undo()
    restored = np.array_equal(sess.current_sr(), sr_before)
    forwards[0] += len(trace)  # the search's Z steps
    want = {k: v * forwards[0] for k, v in EXPECTED_PER_FORWARD.items()}
    tol = cem_tol(sess.cem.conf.kernel)
    check(sess.cem._mode == "fft" and trace[-1] < trace[0] and res <= tol and restored and builds == [0, 0]
          and counts == want,
          f"blind explore (estimate {BLIND_ITERS} iterations, session built in {built:.2f} s): CEM fft under the "
          f"estimate; smooth click loss {trace[0]:.5f} -> {trace[-1]:.5f} in {len(trace)} Z steps, {secs * 1e3:.1f} ms "
          f"({secs * 1e3 / len(trace):.2f} ms per Z step); CEM residual {res:.3g} <= {tol:.3g}; undo restores the SR "
          f"bit for bit {restored}; layouts built {builds}; launches {counts} == {want} ({forwards[0]} G calls)")
    return counts


def gan_grad_band(model, what: str) -> None:
    """G's gradients of one GAN step on a fixed B16 x HR 128 batch through the
    kernels against the bf16 and f32 plain paths (phase 8's band)."""
    g, cem = model.g_module, model.cem
    ds = SyntheticDataset({"phase": "train", "n_images": B, "image_size": 160, "HR_size": TRAIN_HR})
    hr_u8 = torch.from_numpy(np.stack([ds[i]["HR"] for i in range(B)])).to(BLIND_DEVICE)
    batch = make_train_pipeline(num_latent_channels=NZ)(hr_u8, torch.Generator().manual_seed(0))

    def grad_step(g_call):
        cap, dcap = GradCapture(g.parameters()), GradCapture(model.d_module.parameters())
        stats = {k: v.clone() for k, v in model.d_module.state_dict().items()}
        step = make_gan_train_step(g_call, model.d_module, model.f_module, cem, lambda h, gen: batch,
                                   model.opt["train"], cap, dcap, model.schedulers["G"],
                                   step_keyed(model.schedulers["D"]))
        metrics = step(None, torch.Generator(), 1)
        model.d_module.load_state_dict(stats)
        return metrics, cap.grads

    (m_k, g_k), counts, _ = counted(lambda: grad_step(g))
    _, g_b = grad_step(lambda x, zz: plain_forward(g, x, zz, torch.bfloat16))
    _, g_f = grad_step(lambda x, zz: plain_forward(g, x, zz, torch.float32))
    worst, rows_k, rows_b = grad_band([n for n, _ in g.named_parameters()], g_k, g_b, g_f)
    check(worst <= 1.0 and counts == EXPECTED_PER_FORWARD and math.isfinite(float(m_k["l_g"])),
          f"{what}: one GAN step's G gradients through the kernels vs f32 plain within twice the bf16 plain path's "
          f"relative L2 (floor {GRAD_BAND_FLOOR:.3g}), {len(rows_k)} tensors: kernel median "
          f"{statistics.median(rows_k):.3g} max {max(rows_k):.3g}, bf16 plain median {statistics.median(rows_b):.3g}; "
          f"worst ratio {worst:.3f}; launches {counts}")


@torch.no_grad()
def variant_forward(g, what: str, counters, want: dict, batch: int = B, residual_as_plain: bool = False) -> dict:
    """A generator variant's CEM-wrapped forward at B``batch`` x LR 128:
    launches, PSNR against the f32 plain path beside the bf16 plain path's,
    CEM residual, ms. ``residual_as_plain``: the residual is held to
    CEM_TOL or, where it is larger, the bf16 plain path's own (CEM's f32
    rounding grows with the output's magnitude, which the weights set)."""
    cem = make_cem(CEMConf(scale=SCALE), device=BLIND_DEVICE)
    fwd = make_eval_forward(g, cem)
    gen_ = torch.Generator(BLIND_DEVICE).manual_seed(5)
    lr = torch.rand(batch, LR, LR, 3, device=BLIND_DEVICE, generator=gen_)
    z = torch.rand(batch, LR, LR, NZ, device=BLIND_DEVICE, generator=gen_) * 2 - 1
    out, counts, _ = counted(lambda: fwd(lr, z), counters)
    ref32 = cem.project(plain_forward(g, lr, z, torch.float32), lr)
    p16 = cem.project(plain_forward(g, lr, z, torch.bfloat16), lr)
    pk, pp = psnr(out, ref32), psnr(p16, ref32)
    res, res_plain = max_err(cem.downsample(out), lr), max_err(cem.downsample(p16), lr)
    res_tol = max(CEM_TOL, res_plain) if residual_as_plain else CEM_TOL
    ms = cuda_ms(lambda: fwd(lr, z), reps=2, warmup=1, windows=3)
    ms_plain = cuda_ms(lambda: cem.project(plain_forward(g, lr, z, torch.bfloat16), lr), reps=2, warmup=1, windows=3)
    check(counts == want and pk >= pp - PSNR_MARGIN_DB and res <= res_tol,
          f"{what} forward B{batch} x LR {LR}: launches {counts} == {want}; PSNR vs f32 plain: kernels {pk:.2f} dB, bf16 "
          f"plain {pp:.2f} dB (margin {PSNR_MARGIN_DB}); CEM residual {res:.3g} <= {res_tol:.3g} (bf16 plain path's "
          f"{res_plain:.3g}, f32 plain path's {max_err(cem.downsample(ref32), lr):.3g}, max |out| "
          f"{out.abs().max().item():.3g}); {ms:.2f} ms per forward, bf16 plain {ms_plain:.2f} ms")
    return counts


def srresnet_upconv_rows(g) -> list[dict]:
    """SRResNet's 64 -> 256 ``upconv``s on the tensor-core kernel at their
    forward shapes, with the layouts the forward uses: within phase 3's bf16
    conv band, and no slower than ``F.conv2d`` measured beside them."""
    rows = []
    for i, s in ((1, LR), (2, 2 * LR)):
        m = getattr(g, f"upconv{i}")
        x = torch.randn(B, s, s, NF, device=BLIND_DEVICE, generator=torch.Generator(BLIND_DEVICE).manual_seed(i)).bfloat16()
        row = conv_wide_row(x, m.hwio(), m.bias, 3, f"SRResNet upconv{i}", kw=m.kernel_weights)
        check(row["ms"] <= row["library_ms"],
              f"SRResNet upconv{i} at B{B} {s}x{s} 64->256: kernel {row['ms']:.4f} ms <= F.conv2d "
              f"{row['library_ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.0f}% of the bound)")
        rows.append(row)
    return rows


def phase_blind(tmp: Path, pth: str, rows: list[dict], card: str) -> dict[str, dict]:
    """Phase 10: blind SR and the generator variants; returns the launches by
    path."""
    t_phase = time.perf_counter()
    launches = {}
    blind_cem_checks()
    lr96, _ = kernelgan_checks(tmp, card)
    lr_png = blind_cli_checks(tmp, lr96)
    launches["blind_eval"] = blind_eval_checks(tmp, pth)
    launches["blind_explore"] = blind_explore_checks(tmp, pth, lr_png)

    # (f) all_layers: the flagship with Z re-injected before every RRDB
    # The reference init (Kaiming, gain sqrt 2) of the 23 unactivated 1x1 projections grows the trunk
    # ~3000x; at unit gain the outputs stay images, and PSNR and the GAN losses mean something.
    net_al = {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ, "latent_input": "all_layers"}
    g = define_G({"network_G": net_al, "scale": SCALE, "bf16": True}, device=BLIND_DEVICE, seed=0)
    with torch.no_grad():
        for proj in g.latent_proj:
            proj.weight.mul_(2**-0.5)
    al_pth = str(tmp / "G_all_layers.pth")
    torch.save(g.state_dict(), al_pth)
    launches["all_layers"] = variant_forward(g, "all_layers flagship", COUNTERS, EXPECTED_PER_FORWARD)
    del g
    opt = train_options(tmp / "all_layers", "train_all_layers", "train_explorable_SR.json", None, niter=2)
    opt["network_G"]["latent_input"] = "all_layers"
    opt["path"]["pretrain_model_G"] = al_pth
    model = create_model(parse(opt, is_train=True), device=BLIND_DEVICE)
    gan_grad_band(model, "all_layers")
    ds = SyntheticDataset({"phase": "train", "n_images": B, "image_size": 160, "HR_size": TRAIN_HR})
    model.feed_data({"HR": np.stack([ds[i]["HR"] for i in range(B)])})
    times = []

    def two_steps():
        for s in (1, 2):
            t0 = time.perf_counter()
            model.optimize_parameters(s)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return model.get_current_losses()

    losses, counts, _ = counted(two_steps)
    want = {k: 2 * v for k, v in EXPECTED_PER_FORWARD.items()}
    check(counts == want and all(math.isfinite(v) for v in losses.values()),
          f"all_layers GAN trainer, 2 steps at B{B} x HR {TRAIN_HR}: launches {counts} == {want}; l_g "
          f"{losses['l_g']:.5f}, l_d {losses['l_d']:.5f}; {times[0]:.1f} / {times[1]:.1f} ms per step")
    launches["all_layers_train"] = counts
    del model

    # (f) SRResNet nf 64, nb 16, x4: 38 tensor-core convs per forward (the
    # two 64 -> 256 upconvs in four Cout slices each)
    net_sr = {"which_model_G": "sr_resnet", "nf": NF, "nb": 16, "num_latent_channels": NZ}
    g = define_G({"network_G": net_sr, "scale": SCALE, "bf16": True}, device=BLIND_DEVICE, seed=0)
    per_fwd = {"rdb5c": 0, "conv3x3": 38, "upsample2x_conv3x3": 0}
    launches["srresnet"] = variant_forward(g, "SRResNet nf 64 nb 16 x4", COUNTERS, per_fwd)
    conv_row = next(r for r in rows if r["name"] == "conv3x3")
    conv_row["bf16_wide"] += srresnet_upconv_rows(g)
    del g
    opt_sr = train_options(tmp / "srresnet", "train_srresnet", "train_RRDB_PSNR.json", None, niter=2)
    opt_sr["network_G"] = dict(net_sr, num_latent_channels=0)
    _, counts, secs = run_train(tmp / "srresnet", opt_sr, "--device", BLIND_DEVICE)
    want = {k: 2 * v for k, v in per_fwd.items()}
    srows = train_csv(tmp / "srresnet", "train_srresnet")
    check(counts == want and len(srows) == 2 and all(math.isfinite(float(r["l_pix"])) for r in srows),
          f"SRResNet SR trainer, 2 steps: launches {counts} == {want}; l_pix "
          f"{[round(float(r['l_pix']), 5) for r in srows]}; {secs:.1f} s")
    launches["srresnet_train"] = counts
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the parallel axes, 2 ranks on the one card over gloo

PAR_WIDTHS = {"nf": NF, "nb": NB, "gc": GC}  # the flagship's
PAR_NB_PP = 24  # the pipeline's depth: the flagship's 23 does not divide over 2 stages
# eval_spatial halos: at LR 128 a halo of 32 makes each window the whole image, 16 windows of 96 rows
PAR_HALOS = (32, 16)
PAR_TRAIN_HALO = 4  # train_spatial at LR 32: windows of 24 of the 32 rows
TP_CONV_BOUND = 2.0**-6  # eval_tp: a row-parallel conv's sum against the f32 conv, relative max error
PAR_LABEL = "2 ranks on one H100 over gloo"
ZERO_BY_DESIGN.update({p: ("rdb5c",) for p in ("eval_tp", "train_tp")})


def par_eval_options(tmp: Path, pth: str, name: str, nb: int | None = None, datasets=None, **extra) -> dict:
    opt = flagship_options(tmp, pth, name, datasets or {}, dist_backend="gloo", **extra)
    opt["network_G"].update(PAR_WIDTHS if nb is None else dict(PAR_WIDTHS, nb=nb))
    return opt


def par_train_options(tmp: Path, name: str, nb: int | None = None, **extra) -> dict:
    opt = train_options(tmp, name, "train_explorable_SR.json", None, niter=2)
    opt["network_G"].update(PAR_WIDTHS if nb is None else dict(PAR_WIDTHS, nb=nb))
    opt.update(dist_backend="gloo", **extra)
    return opt


def par_counts(counters=COUNTERS) -> dict:
    return {c.name: c.count for c in counters}


def par_digest(states: list[dict]) -> str:
    import hashlib

    h = hashlib.sha256()
    for st in states:
        for k in sorted(st):
            h.update(k.encode())
            h.update(st[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def par_gan_step(opt: dict, hr_u8: torch.Tensor, device, fault=None) -> dict:
    """One GAN step (then a timed second one) of the trainer ``opt`` builds, on
    this rank's rows of the fixed host batch: losses, G's step-1 gradients (full
    width, rank 0), launches of step 1, ms of step 2, a digest of G and D."""
    import contextlib

    from esr_tpu_torch.parallel import tensor as ptensor

    model = create_model(parse(opt, is_train=True), device=device)
    seen = []
    step = model.g_opt.step

    def record(grads, lr, sq_sum=None):
        seen.append([g.detach().float() for g in grads])
        step(grads, lr, sq_sum)

    model.g_opt.step = record
    i, n = model.data_shard()
    rows = hr_u8[i * hr_u8.shape[0] // n : (i + 1) * hr_u8.shape[0] // n]
    with fault() if fault is not None else contextlib.nullcontext():
        model.feed_data({"HR": rows})
        for c in COUNTERS:
            c.reset()
        model.optimize_parameters(1)
        torch.cuda.synchronize()
        counts = par_counts()
        losses = model.get_current_losses()
        model.feed_data({"HR": rows})
        t0 = time.perf_counter()
        model.optimize_parameters(2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    names = [nm for nm, _ in model.g_module.named_parameters()]
    grads = dict(zip(names, ptensor.full_param_tensors(model.g_module, seen[0])))
    digest = par_digest([model._full_state(model.g_module), model.d_module.state_dict()])
    out = {"losses": losses, "counts": counts, "ms": ms, "digest": digest, "shard": (i, n)}
    if dist_rank() == 0:
        out["grads"] = {k: v.cpu() for k, v in grads.items()}
    del model
    return out


def dist_rank() -> int:
    from esr_tpu_torch.parallel import comm

    return comm.world()[0]


@torch.no_grad()
def par_forward(opt: dict, lr: torch.Tensor, z: torch.Tensor, device, raw_fn=None, timed: bool = True,
                fault=None, inspect=None) -> dict:
    """The eval forward ``opt`` builds (``create_model``), counted, then timed
    by a second call (``timed``; else the counted call is timed): the SR (and
    the raw G output ``raw_fn(model)`` gives) on rank 0, and the LR heights G
    ran on (a spatial window's). ``fault``: a context the counted call runs
    in; ``inspect(model)``, called before it, returns a function whose dict
    joins the result after it (and before the timed call)."""
    import contextlib

    model = create_model(parse(opt, is_train=False), device=device)
    after = inspect(model) if inspect is not None else None
    rows = set()
    hook = model.g_module.conv_first.register_forward_pre_hook(lambda m, a: rows.add(a[0].shape[1]))
    for c in COUNTERS:
        c.reset()
    t0 = time.perf_counter()
    with fault() if fault is not None else contextlib.nullcontext():
        sr = model._forward(lr, z)
    hook.remove()
    torch.cuda.synchronize()
    counts = par_counts()
    out = {"counts": counts, "rows": sorted(rows), **(after() if after is not None else {})}
    if timed:
        t0 = time.perf_counter()
        model._forward(lr, z)
        torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    raw = raw_fn(model) if raw_fn is not None else None
    if dist_rank() == 0:
        out["sr"] = sr.cpu()
        out["raw"] = None if raw is None else raw.cpu()
    del model
    return out


def tp_convs(model):
    """``par_forward``'s inspector for eval_tp: as each row-parallel RDB runs,
    each of its five convs' sum of the ranks' partials (before the bias)
    against the f32 conv of the full weight (the slices gathered) on the same
    input, the features the RDB built from those sums; after the forward,
    ``conv_rel``: max |error| / max |f32 conv| of every conv in order."""
    from esr_tpu_torch.models.blocks import lrelu
    from esr_tpu_torch.parallel import comm

    orig, sums, rel = comm.reduce, [], []

    def reduce(x, g):
        y = orig(x, g)
        sums.append(y)
        return y

    def pre(m, a):
        sums.clear()
        comm.reduce = reduce

    def post(m, a, y):
        comm.reduce = orig
        x = a[0]
        feats = [x]
        for k, got in enumerate(sums, start=1):
            conv = getattr(m, f"conv{k}")
            w = comm.gather(conv.weight, m.tp.group, dim=1).float()
            with full_f32():
                want = F.conv2d(torch.cat(feats, -1).float().permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
            rel.append(max_err(got, want) / want.abs().max().item())
            if k < 5:  # the RDB's own next input: lrelu of the rounded sum plus bias
                feats.append(lrelu((got + conv.bias).to(x.dtype)))
        sums.clear()

    rdbs = [getattr(b, f"RDB{j}") for b in model.g_module.RRDB_trunk for j in (1, 2, 3)]
    hooks = [h for r in rdbs for h in (r.register_forward_pre_hook(pre), r.register_forward_hook(post))]

    def after() -> dict:
        for h in hooks:
            h.remove()
        return {"conv_rel": list(rel)}

    return after


def par_rank(spec: dict) -> dict:
    """Phase 11 on one rank (``comm.spawn``): the sharded eval forwards (and
    eval_tp's with a planted fault), the eval CLI under dist_eval, and one GAN
    step of each train axis and of its planted fault; rank 0 returns the
    tensors, every rank its counts."""
    import contextlib

    from esr_tpu_torch import parallel as P
    from esr_tpu_torch.parallel import comm, pipeline
    from esr_tpu_torch.parallel import tensor as ptensor

    device = comm.rank_device("cuda")
    torch.cuda.set_device(device)
    tmp = Path(spec["tmp"])
    lr, z = spec["lr"].to(device), spec["z"].to(device)
    out = {"device": str(device), "backend": torch.distributed.get_backend()}
    for halo in PAR_HALOS:
        opt = par_eval_options(tmp, spec["pth"], f"par_spatial{halo}", eval_spatial=2, eval_spatial_halo=halo)
        out[f"eval_spatial{halo}"] = par_forward(opt, lr, z, device, lambda m, h=halo: P.spatial_window_forward(
            m.g_module, m._eval_mesh, scale=SCALE, halo=h)(lr, z))

    @contextlib.contextmanager
    def dropped_partial():  # rank 1's partial of the first row-parallel conv left out of the sum
        orig, calls = ptensor._partial_conv, [0]

        def patched(conv, xs):
            part = orig(conv, xs)
            calls[0] += 1
            return torch.zeros_like(part) if comm.world()[0] == 1 and calls[0] == 1 else part

        ptensor._partial_conv = patched
        try:
            yield
        finally:
            ptensor._partial_conv = orig

    # its 345 partial sums through the host take seconds a forward
    tp_opt = par_eval_options(tmp, spec["pth"], "par_tp", eval_tp=2)
    out["eval_tp"] = par_forward(tp_opt, lr, z, device, inspect=tp_convs)
    # the planted fault on 2 of the images (the conv check reads each conv alone; the sums through the host
    # shrink with the batch)
    out["eval_tp_fault"] = par_forward(tp_opt, lr[:2], z[:2], device, timed=False, fault=dropped_partial,
                                       inspect=tp_convs)
    out["eval_pp"] = par_forward(par_eval_options(tmp, spec["pth_pp"], "par_pp", nb=PAR_NB_PP, eval_pp=2),
                                 lr, z, device)
    # the eval CLI in this process group: dist_eval over the 2 ranks
    path = tmp / f"par_dist_eval_{comm.world()[0]}.json"
    path.write_text(json.dumps(spec["dist_eval_opt"]))
    res, counts, secs = counted(lambda: eval_cli.main(["-opt", str(path), "--device", "cuda"]))
    out["dist_eval"] = {"metrics": res, "counts": counts, "s": secs}
    torch.cuda.empty_cache()

    hr_u8 = spec["hr_u8"]  # host rows, as a loader hands them over

    @contextlib.contextmanager
    def tp_scaled():  # the row-parallel sum's backward scaled by T (a psum's transpose counted T times)
        orig = comm._Reduce.backward
        comm._Reduce.backward = staticmethod(lambda ctx, grad: (grad * 2, None))
        try:
            yield
        finally:
            comm._Reduce.backward = orig

    @contextlib.contextmanager
    def dropped_micro():  # the first microbatch's gradient dropped from the pipeline's backward
        orig = pipeline._Schedule.backward

        def drop(self, inputs, x, zz, grad_out, params, needs):
            g = grad_out.clone()
            g[: g.shape[0] // self.m] = 0
            return orig(self, inputs, x, zz, g, params, needs)

        pipeline._Schedule.backward = drop
        try:
            yield
        finally:
            pipeline._Schedule.backward = orig

    runs = {"train_dist": (par_train_options(tmp / "par_dist", "par_dist", dist=True), None),
            "train_tp": (par_train_options(tmp / "par_tp", "par_tp", train_tp=2), None),
            "train_tp_fault": (par_train_options(tmp / "par_tpf", "par_tpf", train_tp=2), tp_scaled),
            "train_spatial": (par_train_options(tmp / "par_sp", "par_sp", train_spatial=2,
                                                train_spatial_halo=PAR_TRAIN_HALO), None),
            "train_spatial_fault": (par_train_options(tmp / "par_spf", "par_spf", train_spatial=2,
                                                      train_spatial_halo=0), None),
            "train_pp": (par_train_options(tmp / "par_pp", "par_pp", nb=PAR_NB_PP, train_pp=2), None),
            "train_pp_fault": (par_train_options(tmp / "par_ppf", "par_ppf", nb=PAR_NB_PP, train_pp=2),
                               dropped_micro)}
    for name, (opt, fault) in runs.items():
        out[name] = par_gan_step(opt, hr_u8, device, fault)
        torch.cuda.empty_cache()
    return out


def par_grad_band(bands: dict, got: dict, want: dict) -> tuple[float, float]:
    """The worst ratio of a tensor's relative L2 (``got`` against ``want``) to
    its phase 8 band, and the largest relative L2; a name phase 8 has no band
    for (block 23 of the 24-block pipeline net) takes the trunk's widest."""
    trunk = max((v for k, v in bands.items() if k.startswith("RRDB_trunk.")), default=GRAD_BAND_FLOOR)
    worst = biggest = 0.0
    for k, w in want.items():
        if k in NOISE_GRADS:
            continue
        r = rel_l2(got[k], w)
        biggest = max(biggest, r)
        worst = max(worst, r / bands.get(k, trunk if k.startswith("RRDB_trunk.") else GRAD_BAND_FLOOR))
    return worst, biggest


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_parallel(tmp: Path, pth: str, card: str, bands: dict) -> dict[str, dict]:
    """Phase 11: every parallel axis on 2 ranks sharing the one card over
    gloo (spawned, a file store); returns the launches by path (both ranks).
    ``bands``: phase 8's per-tensor gradient bands ("grads") and per-metric
    loss bands ("losses") of the GAN step at this shape."""
    import re

    from esr_tpu_torch.parallel import comm

    tmp = tmp / "parallel"
    tmp.mkdir(parents=True, exist_ok=True)
    device = "cuda"
    rng = np.random.default_rng(11)
    lr = torch.from_numpy(rng.random((B, LR, LR, 3), dtype=np.float32))
    z = torch.from_numpy(rng.uniform(-1, 1, (B, LR, LR, NZ)).astype(np.float32))
    pth_pp = str(tmp / "G_nb24.pth")
    g_opt = {"network_G": dict(PAR_WIDTHS, nb=PAR_NB_PP, num_latent_channels=NZ), "scale": SCALE}
    torch.save(define_G(g_opt, device=device, seed=0).state_dict(), pth_pp)
    ds = SyntheticDataset({"phase": "train", "n_images": B, "image_size": 160, "HR_size": TRAIN_HR})
    hr_u8 = torch.from_numpy(np.stack([ds[i]["HR"] for i in range(B)]))
    datasets = {"test_1": {"name": "synthetic", "mode": "SYNTHETIC", "n_images": 4, "image_size": 512}}
    dist_eval_opt = par_eval_options(tmp, pth, "par_dist_eval", datasets=datasets, num_random_Z=2, dist_eval=True,
                                     eval_batch=2)

    # the references, one process: the whole-image forwards and the one-process GAN steps
    t0 = time.perf_counter()
    with torch.no_grad():
        model = create_model(parse(par_eval_options(tmp, pth, "par_ref"), is_train=False), device=device)
        g, cem = model.g_module, model.cem
        lr_d, z_d = lr.to(device), z.to(device)
        ref_raw = g(lr_d, z_d)
        ref = cem.project(ref_raw, lr_d)
        ref32 = cem.project(plain_forward(g, lr_d, z_d, torch.float32), lr_d)
        plain16 = cem.project(plain_forward(g, lr_d, z_d, torch.bfloat16), lr_d)
        p_plain = psnr(plain16, ref32)
        plain_rel = max_err(plain16, ref) / ref.abs().max().item()
        refs = {"raw": ref_raw.cpu(), "sr": ref.cpu(), "f32": ref32.cpu()}
        del model, g, ref32, plain16
        model = create_model(parse(par_eval_options(tmp, pth_pp, "par_ref_pp", nb=PAR_NB_PP), is_train=False),
                             device=device)
        refs["pp"] = model._forward(lr_d, z_d).cpu()
        del model
    one = {}
    for name, nb in (("flagship", None), ("pp", PAR_NB_PP)):
        opt = par_train_options(tmp / f"one_{name}", f"one_{name}", nb=nb)
        one[name] = par_gan_step(opt, hr_u8, device)
    batched, _, _ = run_cli(tmp, dict(dist_eval_opt, name="par_one_batched", dist_eval=False, eval_batch=4),
                            "--device", device)
    torch.cuda.empty_cache()
    print(f"parallel: references (whole-image forwards, f32 / bf16 plain, one-process GAN steps, one-rank "
          f"batched eval) in {time.perf_counter() - t0:.1f} s", flush=True)

    spec = {"tmp": str(tmp), "pth": pth, "pth_pp": pth_pp, "lr": lr, "z": z, "hr_u8": hr_u8,
            "dist_eval_opt": dist_eval_opt}
    t0 = time.perf_counter()
    ranks = comm.spawn(par_rank, 2, tmp / "store", args=(spec,), backend="gloo", timeout=900.0)
    print(f"parallel: 2 ranks spawned and run in {time.perf_counter() - t0:.1f} s", flush=True)
    r0 = ranks[0]
    check([r["backend"] for r in ranks] == ["gloo", "gloo"] and all(r["device"].startswith("cuda")
                                                                    for r in ranks),
          f"parallel: ranks on {[r['device'] for r in ranks]} over {[r['backend'] for r in ranks]} (explicit; "
          "NCCL cannot put two ranks on one GPU)")
    launches = {}

    def per_rank(name, want):
        counts = [r[name]["counts"] for r in ranks]
        check(all(c == want for c in counts), f"{name}: launches per rank {counts} == {want}")
        launches[name] = {k: sum(c[k] for c in counts) for k in want}

    # (a) eval_spatial
    per_forward = EXPECTED_PER_FORWARD
    seam = LR // 2 * SCALE
    for halo in PAR_HALOS:
        a = r0[f"eval_spatial{halo}"]
        key = f"eval_spatial{halo}"
        per_rank(key, per_forward)
        far = torch.cat([a["raw"][:, : seam - halo * SCALE], a["raw"][:, seam + halo * SCALE:]], 1)
        far_ref = torch.cat([refs["raw"][:, : seam - halo * SCALE], refs["raw"][:, seam + halo * SCALE:]], 1)
        exact = bool(torch.equal(far, far_ref))
        res = max_err(cem.downsample(a["sr"].to(device)), lr_d)
        pk = psnr(a["sr"], refs["f32"])
        check(res <= CEM_TOL and pk >= p_plain - PSNR_MARGIN_DB,
              f"(a) eval_spatial 2, halo {halo}: CEM residual {res:.3g} <= {CEM_TOL}; PSNR vs f32 plain "
              f"{pk:.2f} dB (bf16 plain {p_plain:.2f}, margin {PSNR_MARGIN_DB}); max |sr - whole-image forward| "
              f"{max_err(a['sr'], refs['sr']):.3g}")
        window = min(LR, LR // 2 + 2 * halo)
        check(exact and a["rows"] == [window],
              f"(a) eval_spatial 2, halo {halo}: G ran on windows of {a['rows']} of {LR} LR rows (want {window}); "
              f"raw G rows >= a halo from the seam equal the whole-image kernel forward's bit for bit: {exact} "
              f"(max diff {max_err(far, far_ref):.3g}; at the seam {max_err(a['raw'], refs['raw']):.3g})")
    # (b) eval_tp
    per_rank("eval_tp", {"rdb5c": 0, "conv3x3": 4 + 5 * 3 * PAR_WIDTHS["nb"], "upsample2x_conv3x3": 2})
    pk = psnr(r0["eval_tp"]["sr"], refs["f32"])
    top = refs["sr"].abs().max().item()
    tp_rel = max_err(r0["eval_tp"]["sr"], refs["sr"]) / top
    # the output bound: twice the bf16 plain path's own distance from the kernel forward
    check(pk >= p_plain - PSNR_MARGIN_DB and max_err(cem.downsample(r0["eval_tp"]["sr"].to(device)), lr_d) <= CEM_TOL
          and tp_rel <= 2 * plain_rel,
          f"(b) eval_tp 2: PSNR vs f32 plain {pk:.2f} dB (bf16 plain {p_plain:.2f}, margin {PSNR_MARGIN_DB}); max "
          f"|sr - whole-image kernel forward| / max |whole| {tp_rel:.4g} <= 2 x the bf16 plain path's "
          f"{plain_rel:.4g} (max |whole| {top:.4g})")
    n_conv = 15 * PAR_WIDTHS["nb"]
    convs = [max(r["eval_tp"]["conv_rel"]) for r in ranks]
    check(all(len(r["eval_tp"]["conv_rel"]) == n_conv for r in ranks) and max(convs) <= TP_CONV_BOUND,
          f"(b) eval_tp 2: each of the {n_conv} row-parallel convs' sum of partials against the f32 conv of the "
          f"gathered weight on its input: worst relative max error per rank {convs} <= {TP_CONV_BOUND} (median "
          f"{float(np.median(r0['eval_tp']['conv_rel'])):.4g})")
    f = r0["eval_tp_fault"]["conv_rel"]
    check(f[0] > TP_CONV_BOUND >= max(f[1:]),
          f"(b) eval_tp 2 on 2 images, rank 1's partial of the first RDB's conv1 dropped: that conv {f[0]:.4g} > "
          f"{TP_CONV_BOUND} >= the other {len(f) - 1}'s worst {max(f[1:]):.4g}: the conv bound fails it, and only it; "
          f"max |sr - whole| / max |whole| on those 2 images "
          f"{max_err(r0['eval_tp_fault']['sr'], refs['sr'][:2]) / top:.4g} (the output bound {2 * plain_rel:.4g} is "
          "not made to see one conv)")
    # (c) eval_pp
    n_micro = 8 if B == 16 else B
    per_rank("eval_pp", {"rdb5c": 3 * PAR_NB_PP // 2 * n_micro, "conv3x3": 4, "upsample2x_conv3x3": 2})
    check(torch.equal(r0["eval_pp"]["sr"], refs["pp"]),
          f"(c) eval_pp 2 at nb {PAR_NB_PP}, {n_micro} microbatches: the single-rank forward bit for bit "
          f"(max diff {max_err(r0['eval_pp']['sr'], refs['pp']):.3g}); "
          f"{3 * PAR_NB_PP // 2} rdb5c launches per stage per microbatch")
    # (d) dist_eval, in the ranks' process group
    d = [r["dist_eval"] for r in ranks]
    check(d[1]["metrics"] == {}, "(d) dist_eval: rank 1 reports nothing (rank 0 scores and writes)")
    for k, v in batched["synthetic"].items():
        got = d[0]["metrics"]["synthetic"].get(k, math.inf)
        tol = CEM_TOL if k == "cem_residual" else METRIC_TOL.get(k, 1e-3 * abs(v))
        check(got <= CEM_TOL if k == "cem_residual" else abs(got - v) <= tol,
              f"(d) dist_eval over 2 ranks [{k}]: {got:.6f}, one-rank batched {v:.6f} (tol {tol:.3g})")
    launches["dist_eval"] = {k: sum(r["counts"][k] for r in d) for k in per_forward}
    # 4 images, 2 a rank (eval_batch 2): one forward a draw on each rank
    check([r["counts"] for r in d] == [{k: v * 3 for k, v in per_forward.items()}] * 2,
          f"(d) dist_eval: 4 images dealt 2 a rank, 3 draws: launches per rank {[r['counts'] for r in d]} (3 "
          "forwards each)")
    # (e), (f) the GAN steps
    steps_want = {"train_dist": per_forward, "train_spatial": per_forward,
                  "train_tp": {"rdb5c": 0, "conv3x3": 4 + 5 * 3 * PAR_WIDTHS["nb"], "upsample2x_conv3x3": 2},
                  "train_pp": {"rdb5c": 2 * 3 * PAR_NB_PP // 2 * n_micro, "conv3x3": 4, "upsample2x_conv3x3": 2}}
    for name, want in steps_want.items():
        per_rank(name, want)
        ref = one["pp" if name == "train_pp" else "flagship"]
        got = r0[name]
        ldiff = {k: abs(got["losses"][k] - v) / (1.0 if k in ("D_real", "D_fake") else max(abs(v), 1e-12))
                 for k, v in ref["losses"].items()}
        lworst = max(ldiff, key=lambda k: ldiff[k] / bands["losses"].get(k, GRAD_BAND_FLOOR))
        lratio = ldiff[lworst] / bands["losses"].get(lworst, GRAD_BAND_FLOOR)
        worst, biggest = par_grad_band(bands["grads"], got["grads"], ref["grads"])
        same = len({r[name]["digest"] for r in ranks}) == 1
        check(lratio <= 1.0 and worst <= 1.0 and same,
              f"({'e' if name == 'train_dist' else 'f'}) {name}, one GAN step at B{B} x HR {TRAIN_HR} (rows "
              f"{[r[name]['shard'] for r in ranks]}): losses within phase 8's band of one process's (worst "
              f"{lworst} {ldiff[lworst]:.3g}, ratio {lratio:.3f}; l_g_pix {ldiff.get('l_g_pix', math.nan):.3g}); "
              f"G's gradients within phase 8's band of its (worst ratio {worst:.3f}, largest relative L2 "
              f"{biggest:.3g}); G and D bit-identical on both ranks: {same}")
        fault = name + "_fault"
        if fault in r0:
            fw, fb = par_grad_band(bands["grads"], r0[fault]["grads"], ref["grads"])
            what = {"train_tp_fault": "the row-parallel sum's backward scaled by T",
                    "train_spatial_fault": "a halo of 0 at the seam",
                    "train_pp_fault": "the first microbatch's gradient dropped"}[fault]
            check(fw > 1.0, f"(f) {name} with {what}: worst ratio to the band {fw:.3f} > 1 (largest relative L2 "
                  f"{fb:.3g}): the band fails it")
        launches[name] = {k: sum(r[name]["counts"][k] for r in ranks) for k in want}

    # (d) the eval CLI under torch.distributed.run, and (g) the multihost dry run
    path = tmp / "par_torchrun.json"
    path.write_text(json.dumps(dict(dist_eval_opt, name="par_torchrun")))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_port",
                          str(free_port()), "-m", "esr_tpu_torch.test", "-opt", str(path), "--save_images",
                          "--device", "cuda"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO))
    secs = time.perf_counter() - t0
    text = run.stdout + run.stderr
    lines = [ln for ln in text.splitlines() if "avg PSNR" in ln]
    m = re.search(r"avg PSNR: ([0-9.]+) dB, avg SSIM: ([0-9.]+)", lines[0]) if lines else None
    pngs = sorted((tmp / "results" / "par_torchrun" / "synthetic").glob("*.png"))
    b = batched["synthetic"]
    check(run.returncode == 0 and len(lines) == 1 and m is not None
          and abs(float(m.group(1)) - b["psnr"]) <= 1e-3 + 5e-5 and abs(float(m.group(2)) - b["ssim"]) <= 1e-4
          and len(pngs) == 4 * 3,
          f"(d) python -m torch.distributed.run --nproc_per_node 2 -m esr_tpu_torch.test (dist_eval, gloo): rc "
          f"{run.returncode}, {len(lines)} result line(s) (rank 0 alone logs): {m.groups() if m else None} against "
          f"the one-rank batched {b['psnr']:.4f} / {b['ssim']:.4f} (printed to 4 decimals); {len(pngs)} PNGs (4 "
          f"images x 3 draws, rank 0 alone writes); {secs:.1f} s")
    if run.returncode:
        print(text[-3000:], file=sys.stderr, flush=True)
    port = free_port()
    cmd = [sys.executable, "-m", "esr_tpu_torch.parallel.multihost", "--backend", "gloo", "--device", "cuda"]
    procs = [subprocess.Popen(cmd + ["--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id",
                                     str(i)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=str(REPO)) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    single = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))
    try:
        mh = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
        one_mh = json.loads(single.stdout.strip().splitlines()[-1])
        ok = (all(p.returncode == 0 for p in procs) and single.returncode == 0 and mh[0]["loss"] == mh[1]["loss"]
              and abs(mh[0]["loss"] - one_mh["loss"]) <= 1e-5 * abs(one_mh["loss"])
              and abs(mh[0]["param_l1"] - one_mh["param_l1"]) <= 1e-5 * abs(one_mh["param_l1"]))
        what = f"2 processes {[(o['loss'], o['param_l1']) for o in mh]}, 1 process {(one_mh['loss'], one_mh['param_l1'])}"
    except (ValueError, IndexError, KeyError):
        ok, what = False, " / ".join(e[-500:] for _, e in outs) + single.stderr[-500:]
    check(ok, f"(g) python -m esr_tpu_torch.parallel.multihost (CUDA, gloo): the same loss and param_l1: {what}")

    for name in [f"eval_spatial{h}" for h in PAR_HALOS] + ["eval_tp", "eval_pp"]:
        print(f"{PAR_LABEL} ({card}): {name} forward, B{B} x LR {LR}, CEM included: "
              f"{r0[name]['ms']:.2f} ms (host clock, a second forward)", flush=True)
    for name in ("train_dist", "train_tp", "train_spatial", "train_pp"):
        ref = one["pp" if name == "train_pp" else "flagship"]
        print(f"{PAR_LABEL} ({card}): {name} GAN step, B{B} x HR {TRAIN_HR}: {r0[name]['ms']:.1f} ms (one "
              f"process, one card: {ref['ms']:.1f} ms; not a scaling number)", flush=True)
    print(f"{PAR_LABEL} ({card}): dist_eval CLI over the SYNTHETIC set (4 images x 3 draws) "
          f"{d[0]['s']:.2f} s in the ranks, {secs:.1f} s under torch.distributed.run", flush=True)
    return launches



# -- phase 12 ------------------------------------------------------------------

BF16_NAMES = ("rdb5c", "conv3x3", "upsample2x_conv3x3")
SCRIPTS_EXPLORE = ["--regions", "10", "--iters", "2", "--n_steps", "32", "--no-adaptive"]
PARITY_HR = ((128, 96), (96, 128))  # two 1/f HR images: LR 32 x 24 and 24 x 32


def split_counts(counts: dict) -> tuple[dict, dict]:
    """ALL_COUNTERS' counts as (the bf16 kernels', the f32 route's)."""
    return {k: counts[k] for k in BF16_NAMES}, {k: counts[k] for k in F32_PER_FORWARD}


def old_layout(state: dict) -> dict:
    """A state dict with the port's keys in the reference's old RRDBNet layout
    (``model.0`` / ``model.1.sub.{i}.RDB{j}.conv{k}.0`` / ``model.1.sub.{nb}``
    / ``model.3`` / ``model.6`` / ``model.8`` / ``model.10``)."""
    import re

    nb = len({k.split(".")[1] for k in state if k.startswith("RRDB_trunk.")})
    names = {"conv_first": "model.0", "trunk_conv": f"model.1.sub.{nb}", "upconv1": "model.3",
             "upconv2": "model.6", "HRconv": "model.8", "conv_last": "model.10"}
    out = {}
    for k, v in state.items():
        base, leaf = k.rsplit(".", 1)
        m = re.match(r"RRDB_trunk\.(\d+)\.(.+)$", base)
        out[(f"model.1.sub.{m[1]}.{m[2]}.0" if m else names[base]) + "." + leaf] = v
    return out


def host_split(prof, regions=()) -> dict:
    """Host milliseconds of a profile: CUDA runtime launch calls, the
    runtime's synchronising calls (waits), and aten ops' own CPU time; the
    device's busy time and its kernel count (``regions``: annotate ranges,
    which the profiler also lists on the device, left out)."""
    ev = prof.key_averages()
    host = [e for e in ev if e.device_type != torch.autograd.DeviceType.CUDA]
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in regions]
    ms = lambda es: sum(e.self_cpu_time_total for e in es) / 1e3  # noqa: E731
    return {"launch_api_ms": ms(e for e in host if "LaunchKernel" in e.key),
            "launches": sum(e.count for e in host if "LaunchKernel" in e.key),
            "sync_api_ms": ms(e for e in host if e.key.startswith("cu") and ("Synchronize" in e.key or "Memcpy" in e.key)),
            "aten_cpu_ms": ms(e for e in host if e.key.startswith("aten::")),
            "device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "kernels": sum(e.count for e in dev)}


def scripts_trace(tmp: Path, fn, lr, z, card: str) -> dict:
    """The profiler (``utils/profiler``): ``StepTimer`` over flagship
    forwards, then a ``trace`` of a forward and two more, each of those an
    ``annotate`` region: its Chrome trace holds 2 x 69 ``rdb5c_tc_kernel``
    events in the regions' device spans; device ms by kernel and the host
    split are printed. Returns the traced launches."""
    from esr_tpu_torch.utils.profiler import StepTimer, annotate, trace

    timer = StepTimer(warmup=1, device=lr.device)
    for _ in range(6):
        with timer.step():
            fn(lr, z)
    print(f"phase 12 StepTimer: flagship forward B2 x LR 64 {1e3 * timer.mean:.3f} ms/forward over "
          f"{len(timer.times)} timed steps (CUDA events, warmup discarded), {timer.rate(2 * 256 * 256 / 1e6):.3f} "
          f"HR MP/s on {card}", flush=True)
    log_dir = tmp / "trace_forward"
    names = ("flagship_forward_0", "flagship_forward_1")

    def traced():
        # a first forward inside the trace, outside the regions: the first
        # ~40 kernels of a session went missing from its trace on the H100
        with trace(str(log_dir)) as prof:
            fn(lr, z)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for name in names:
                with annotate(name):
                    fn(lr, z)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return prof, wall

    (prof, wall_ms), counts, _ = counted(traced)
    check_launches("phase 12 profiler trace, 3 flagship forwards (2 in regions)", counts, 3)
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "gpu_user_annotation"
             and e.get("name") in names]
    rdb_all = [e for e in events if e.get("cat") == "kernel" and "rdb5c_tc_kernel" in e.get("name", "")]
    # the regions' kernels by correlation with their launch calls (the forward is a CUDA graph: its
    # kernels carry the graph launch's correlation id)
    rdb_regions = sum(region_kernels(events, name)["rdb5c_tc_kernel"] for name in names)
    check(rdb_regions == 2 * 3 * NB,
          f"phase 12 trace.json: {rdb_regions} rdb5c_tc_kernel events launched in the 2 regions == {2 * 3 * NB} "
          f"({len(spans)} device spans; {len(rdb_all)} in the trace, 3 forwards; event categories "
          f"{sorted({str(e.get('cat')) for e in events})})")
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in names]
    split = host_split(prof, names)
    print(f"phase 12 trace, 3 flagship forwards B2 x LR 64: the 2 in regions {wall_ms:.2f} ms of wall under the "
          f"profiler, device busy {split['device_busy_ms']:.3f} ms for the 3; device ms by kernel (3 forwards):",
          flush=True)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} {e.key[:90]}", flush=True)
    print(f"phase 12 host split, 3 forwards: {split}", flush=True)
    return counts


def span_split(events: list, name: str) -> dict:
    """The host split of one ``annotate`` region of a Chrome trace, from the
    events inside it: CUDA launch calls (of kernels and of CUDA graphs, whose
    kernels carry the graph launch's correlation id), the runtime's synchronising calls
    (waits) and aten ops' own CPU time (each host event less the host events
    directly inside it, per thread); the device work (kernels, copies, sets)
    that the region's runtime calls started, matched by correlation id; and
    ``dropped``, the region's launch calls whose kernel the trace lacks."""
    (region,) = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    t0, t1 = region["ts"], region["ts"] + region["dur"]
    host = [dict(e, self=e["dur"]) for e in events if e.get("ph") == "X" and t0 <= e["ts"]
            and e["ts"] + e["dur"] <= t1 and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
    for tid in {e["tid"] for e in host}:
        stack = []
        for e in sorted((e for e in host if e["tid"] == tid), key=lambda e: (e["ts"], -e["dur"])):
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                stack[-1]["self"] -= e["dur"]
            stack.append(e)
    api = [e for e in host if e["cat"] != "cpu_op"]
    launch = {e["args"]["correlation"] for e in api if "LaunchKernel" in e["name"] or "GraphLaunch" in e["name"]}
    corr = {e["args"]["correlation"] for e in api}
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and e.get("args", {}).get("correlation") in corr]
    kernels = {e["args"]["correlation"] for e in dev if e["cat"] == "kernel"}
    ms = lambda es: sum(e["self"] for e in es) / 1e3  # noqa: E731
    return {"launch_api_ms": ms(e for e in api if "LaunchKernel" in e["name"] or "GraphLaunch" in e["name"]),
            "launches": len(launch), "graph_launches": sum("GraphLaunch" in e["name"] for e in api),
            "sync_api_ms": ms(e for e in api if "Synchronize" in e["name"] or "Memcpy" in e["name"]),
            "aten_cpu_ms": ms(e for e in host if e["cat"] == "cpu_op" and e["name"].startswith("aten::")),
            "device_busy_ms": sum(e["dur"] for e in dev) / 1e3, "kernels": len(kernels),
            "dropped": len(launch - kernels)}


def scripts_click_split(card: str) -> None:
    """The profiler's reading of where a host-bound path's time goes: one
    variance click (8 Z steps) of the flagship editor at LR 64, in an
    ``annotate`` region of a ``trace`` that a click outside the region opens
    (the first kernels of a trace can go missing from it): CUDA launch calls,
    waits and aten ops' CPU time against the wall and the device's busy time,
    read from the region's events, once every launch call in it has its
    kernel in the trace."""
    from esr_tpu_torch.explore.session import ExplorationSession
    from esr_tpu_torch.utils.profiler import annotate, trace

    opt = {"network_G": {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ}, "scale": SCALE, "bf16": True}
    g = define_G(opt, device="cuda", seed=0)
    lr = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
    sess = ExplorationSession(g, make_cem(CEMConf(scale=SCALE), device="cuda"), lr, n_steps=8)
    sess.select_rect(0, 0, 40, 40)
    sess.increase_variance()  # the first click at this bucket
    t0 = time.perf_counter()
    sess.increase_variance()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="trace_click_") as log_dir:
        with trace(log_dir):
            sess.increase_variance()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with annotate("variance_click"):
                sess.increase_variance()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = json.loads((Path(log_dir) / "trace.json").read_text())["traceEvents"]
    split = span_split(events, "variance_click")
    check(split["launches"] > 0 and split["dropped"] == 0 and split["kernels"] == split["launches"],
          f"phase 12 click trace: every launch call of the annotated click has its kernel in the trace "
          f"({split['kernels']} kernels, {split['launches']} launch calls, {split['dropped']} dropped)")
    print(f"phase 12 host split, one variance click (8 Z steps, LR 64, region 10 LR) on {card}: {plain_ms:.2f} ms "
          f"without the profiler, {wall_ms:.2f} ms under it: {split}; device idle "
          f"{100 - 100 * split['device_busy_ms'] / plain_ms:.1f}% of the unprofiled click", flush=True)


def scripts_ladder() -> tuple[dict, dict]:
    """The precision ladder in one process on the seeded flagship: bf16
    kernels' PSNR against the f32 oracle at most PSNR_MARGIN_DB below the
    bf16 plain path's, the f32 kernels within F32_TOL of the oracle."""
    from esr_tpu_torch.scripts import precision_ladder

    t0 = time.perf_counter()
    out, counts, _ = counted(lambda: precision_ladder.run_variants(None, device="cuda"), ALL_COUNTERS)
    m = {v: precision_ladder.metrics(out[v], out["f32_plain"]) for v in ("bf16_kernels", "bf16_plain", "f32_kernels")}
    check(m["bf16_kernels"]["psnr_db"] >= m["bf16_plain"]["psnr_db"] - PSNR_MARGIN_DB,
          f"phase 12 precision_ladder (seeded flagship, LR 64 x 48): bf16 kernels {m['bf16_kernels']['psnr_db']:.3f} dB "
          f"against f32_plain, bf16 plain {m['bf16_plain']['psnr_db']:.3f} dB (margin {PSNR_MARGIN_DB} dB)")
    check(m["f32_kernels"]["max"] <= F32_TOL,
          f"phase 12 precision_ladder: f32 kernels max err {m['f32_kernels']['max']:.3g} <= {F32_TOL} from f32_plain")
    print(f"phase 12 precision_ladder: 4 variants in {time.perf_counter() - t0:.2f} s; {m}", flush=True)
    return split_counts(counts)


def scripts_parity(tmp: Path, pth: str) -> dict:
    """``parity_eval`` (f32, TF32 off) on two 1/f PNGs: the seed-0 flagship
    ``.pth`` in the reference's old key layout gives the new layout's PSNR."""
    from esr_tpu_torch.scripts import parity_eval, precision_ladder

    hr_dir = tmp / "parity_hr"
    for i, (h, w) in enumerate(PARITY_HR):
        save_img((precision_ladder.one_over_f_image(h, w, seed=20 + i) * 255).round().astype(np.uint8),
                 str(hr_dir / f"img{i}.png"))
    old = tmp / "G_old_layout.pth"
    torch.save({"state_dict": old_layout(torch.load(pth, map_location="cpu", weights_only=True))}, old)
    reports, f32 = {}, {}
    for name, path in (("new", pth), ("old", str(old))):
        t0 = time.perf_counter()
        reports[name], counts, _ = counted(lambda p=path, n=name: parity_eval.run_parity_eval(
            p, str(hr_dir), out=str(tmp / f"parity_{n}.json"), device="cuda"), ALL_COUNTERS)
        bf16, f32 = split_counts(counts)
        check(not any(bf16.values()) and f32["rdb5c_simt_f32"] == 2 * 3 * NB and f32["conv_f32_kernel"] > 0,
              f"phase 12 parity_eval ({name} layout): the f32 route, {f32}; no bf16 launch {bf16}")
        print(f"phase 12 parity_eval ({name} layout): {time.perf_counter() - t0:.2f} s, {reports[name]}", flush=True)
    d = abs(reports["old"]["psnr"] - reports["new"]["psnr"])
    check(d <= 1e-3 and np.isfinite(reports["new"]["psnr"]) and reports["old"]["num_latent_channels"] == NZ,
          f"phase 12 parity_eval: old-layout PSNR {reports['old']['psnr']} == new-layout {reports['new']['psnr']} "
          f"(|d| {d:.3g} <= 1e-3 dB), Z channels read from conv_first: {reports['old']['num_latent_channels']}")
    return f32


@torch.no_grad()
def scripts_probes(card: str) -> None:
    """The int8 / FP8 probe at one conv shape (and the 8192^3 matmul), and the
    RDB kernel under tile hints at the DIV2K eval shape."""
    from esr_tpu_torch.ops import int8_probe
    from esr_tpu_torch.ops.cuda import tiled_probe

    t0 = time.perf_counter()
    res = int8_probe.run_probes(shapes=((64, 320),), device="cuda")
    print(f"phase 12 int8_probe on {card} ({time.perf_counter() - t0:.2f} s): {json.dumps(res)}", flush=True)
    errs = {k: v for k, v in res.items() if k.endswith("_max_rel_err")}
    check(all(v > 0 for k, v in res.items() if k.endswith("_tfs")) and errs["bf16_conv_64x320_max_rel_err"] <= 2.0**-6
          and all(np.isfinite(v) and v <= 0.25 for v in errs.values()),
          f"phase 12 int8_probe: every rate positive, bf16 im2col GEMM within 2^-6 of the f32 conv, int8 / FP8 "
          f"errors finite and below 0.25 of its largest value: {errs}")
    t0 = time.perf_counter()
    res = tiled_probe.run_tiled_probe(device="cuda")
    print(f"phase 12 tiled_probe on {card} ({time.perf_counter() - t0:.2f} s): {json.dumps(res)}", flush=True)
    errs = list(res["max_abs_err"].values())
    check(res["same_output"] and max(errs) <= 0.125,
          f"phase 12 tiled_probe: the tensor-core RDB kernel gives one answer under every tile hint, max err "
          f"{max(errs):.4g} <= 0.125 from the bf16 plain block")


def phase_scripts(tmp: Path, pth: str, card: str) -> tuple[dict, dict]:
    """Phase 12: the scripts, the profiler, the probes and the port's entry
    point. Returns the launches of the bf16 kernels by path and of the f32
    route by path."""
    from esr_tpu_torch.graft_entry import entry
    from esr_tpu_torch.scripts import ensemble_bench, explore_bench, quickstart

    t_phase = time.perf_counter()
    paths, f32_paths = {}, {}
    fn, (lr, z) = entry(device="cuda")
    out, paths["entry"], secs = counted(lambda: fn(lr, z))
    check_launches("phase 12 graft_entry.entry() forward, B2 x LR 64", paths["entry"], 1)
    res = max_err(make_cem(CEMConf(scale=SCALE), device=lr.device).downsample(out), lr)
    check(tuple(out.shape) == (2, 256, 256, 3) and bool(torch.isfinite(out).all()) and res <= CEM_TOL,
          f"phase 12 entry(): SR {tuple(out.shape)} finite, CEM residual {res:.3g} <= {CEM_TOL} ({secs:.3f} s "
          "with the first call)")
    paths["trace"] = scripts_trace(tmp, fn, lr, z, card)
    del fn, out
    scripts_click_split(card)

    line, paths["explore_bench"], secs = counted(lambda: explore_bench.main(SCRIPTS_EXPLORE + ["--device", "cuda"]))
    check(line["platform"] == torch.cuda.get_device_name(0),
          f"phase 12 explore_bench: platform {line['platform']!r} is the device's name")
    click = line["clicks"][0]
    check(all(paths["explore_bench"].values()) and click["click_s"] > 0 and line["render_s"]["repeat"] > 0,
          f"phase 12 explore_bench ({' '.join(SCRIPTS_EXPLORE)}): {secs:.2f} s, launches {paths['explore_bench']}, "
          f"first click {click['first_s']:.3f} s, repeat {click['click_s']:.3f} s, {click['steps_per_s']:.1f} Z "
          f"steps/s, render {line['render_s']['repeat']:.4f} s on {card}")

    line, paths["ensemble_bench"], secs = counted(lambda: ensemble_bench.main(["--n", "2", "--device", "cuda"]))
    check(all(paths["ensemble_bench"].values()) and line["cost_factor"] > 1
          and max(line["plain"]["cem_residual"], line["ensemble"]["cem_residual"]) <= CEM_TOL
          and np.isfinite(line["psnr_delta_db"]),
          f"phase 12 ensemble_bench --n 2: {secs:.2f} s, launches {paths['ensemble_bench']}, x8 PSNR "
          f"{line['psnr_delta_db']:+.4f} dB, SSIM {line['ssim_delta']:+.5f}, plain {line['plain']['mp_per_s']:.3f} "
          f"/ x8 {line['ensemble']['mp_per_s']:.3f} HR MP/s (cost x{line['cost_factor']:.3f}) on {card}")

    paths["ladder"], f32_paths["ladder"] = scripts_ladder()
    f32_paths["parity_eval"] = scripts_parity(tmp, pth)

    qs_root = tmp / "quickstart"
    edited, counts, secs = counted(lambda: quickstart.main(["--root", str(qs_root), "--niter", "4",
                                                            "--device", "cuda"]), ALL_COUNTERS)
    bf16, f32_paths["quickstart"] = split_counts(counts)
    check(Path(edited).exists() and (qs_root / "experiments" / "quickstart" / "models" / "latest_G.pth").exists()
          and f32_paths["quickstart"]["conv_f32_kernel"] > 0,
          f"phase 12 quickstart --niter 4 (toy net nf 8, f32): trained, evaluated, edited in {secs:.2f} s; "
          f"f32 route {f32_paths['quickstart']}, bf16 {bf16}")
    scripts_probes(card)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths, f32_paths


# -- phase 13: many steps in one dispatch (CUDA graphs) -------------------------

DISPATCH_CHUNK = 4  # the GAN chunk (steps_per_dispatch 4); lr_steps [3]: it spans a milestone
DISPATCH_TIMED = 3  # steps a turn in the timing
Z_STEPS = 64  # the session's steps a search round
GRAPH_KERNELS = ("rdb5c_tc_kernel", "conv_tc_kernel")


def dispatch_models(tmp: Path, json_name: str, n: int = 2, **train) -> list:
    """``n`` models from the same seeds on the port's copy of ``json_name``
    (full width, B16 x HR 128); the second and later run eagerly."""
    opt = train_options(tmp, "dispatch", json_name, None, niter=8, **train)
    models = [create_model(parse(json.loads(json.dumps(opt)), is_train=True)) for _ in range(n)]
    for m in models[1:]:
        m._step_graphs.enabled = False
    return models


def release_memory() -> None:
    """Free a dropped model's graph pool and cached blocks before the next one."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def dispatch_batches(k: int) -> list[dict]:
    ds = SyntheticDataset({"phase": "train", "n_images": B * k, "image_size": 160, "HR_size": TRAIN_HR})
    return [{"HR": np.stack([ds[j]["HR"] for j in range(i * B, (i + 1) * B)])} for i in range(k)]


def train_tensors(model) -> list[tuple[str, torch.Tensor]]:
    """A trainer's weights, buffers and Adam moments, by name."""
    nets = [("G", model.g_module, model.g_opt)]
    if hasattr(model, "d_module"):
        nets.append(("D", model.d_module, model.d_opt))
    out = []
    for tag, net, opt in nets:
        out += [(f"{tag}.{k}", v) for k, v in net.state_dict().items()]
        for key in ("mu", "nu"):
            out += [(f"{tag}.{key}.{i}", t) for i, t in enumerate(getattr(opt, key))]
    return out


def same_training(a, b, start: dict, bands: dict) -> tuple[bool, str]:
    """Two trainers after the same steps: (held, what): bit for bit, or else
    every G weight's update within phase 8's gradient band of the other's
    (relative L2; D's and the moments within the widest), and the last step's
    metrics within its loss bands."""
    ta, tb = train_tensors(a), train_tensors(b)
    la, lb = a.get_current_losses(), b.get_current_losses()
    if la == lb and all(torch.equal(x, y) for (_, x), (_, y) in zip(ta, tb)):
        return True, "bit for bit"
    if bands is None:  # phase 13 alone: no phase 8 bands to fall back on
        return False, "not bit for bit (no phase 8 bands in this run)"
    widest = max(bands["grads"].values())
    worst = 0.0
    for (name, x), (_, y) in zip(ta, tb):
        if not x.is_floating_point() or torch.equal(x, y):
            continue
        x0 = start.get(name)
        ux, uy = (x - x0, y - x0) if x0 is not None else (x, y)
        worst = max(worst, rel_l2(ux, uy) / bands["grads"].get(name[2:], widest))
    for k, v in lb.items():
        scale = 1.0 if k in ("D_real", "D_fake") else max(abs(v), 1e-12)
        worst = max(worst, abs(la[k] - v) / scale / bands["losses"].get(k, widest))
    return worst <= 1.0, f"not bit for bit; worst ratio to phase 8's bands {worst:.3f}"


def region_kernels(events: list, name: str) -> dict:
    """Kernel events of an ``annotate`` region of a Chrome trace by name
    (matched to the region's launch and graph-launch calls by correlation id)."""
    (region,) = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    t0, t1 = region["ts"], region["ts"] + region["dur"]
    corr = {e["args"]["correlation"] for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
            and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})}
    ks = [e for e in events if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in corr]
    return {k: sum(k in e["name"] for e in ks) for k in GRAPH_KERNELS}


def traced(tmp: Path, name: str, warm, fn) -> tuple[dict, dict]:
    """``fn()`` in an ``annotate`` region of a trace that ``warm()`` opens:
    its kernel events by name and its host split (``span_split``)."""
    from esr_tpu_torch.utils.profiler import annotate, trace

    log_dir = tmp / f"trace_{name}"
    with trace(str(log_dir)):
        warm()
        torch.cuda.synchronize()
        with annotate(name):
            fn()
            torch.cuda.synchronize()
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    return region_kernels(events, name), span_split(events, name)


def step_turns(paths: dict, steps, n: int = DISPATCH_TIMED) -> tuple[dict, dict]:
    """ms per step of each path in turns (a, b, c, c, b, a), ``n`` steps a
    turn after one untimed; returns (ms by path, each turn's ms)."""
    names = list(paths)
    ms = {k: [] for k in names}
    for name in names + names[::-1]:
        fn = paths[name]
        fn(next(steps))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(next(steps))
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / n)
    return {k: statistics.mean(v) for k, v in ms.items()}, ms


def frozen_lr_adam():
    """The planted fault: Adam's update reads the learning rate as the Python
    float the host computed last, which a CUDA graph freezes at capture."""
    step, rows = Adam.step, Adam.next_scalars

    def next_scalars(self, lr):
        self.host_lr = float(lr)
        return rows(self, lr)

    def frozen_step(self, grads, lr=None, sq_sum=None):
        if lr is not None:
            self.stage(lr)
        keep = [p.clone() for p in self.params]
        step(self, grads, None, sq_sum)  # the update at the staged scalars, then rescaled to host_lr
        with torch.no_grad():
            upd = torch._foreach_sub(keep, self.params)
            torch._foreach_div_(upd, self.scalars[0])
            torch._foreach_add_(keep, upd, alpha=-self.host_lr)
            for p, k in zip(self.params, keep):
                p.copy_(k)

    return {"step": frozen_step, "next_scalars": next_scalars}


def dispatch_gan(tmp: Path, card: str, bands: dict) -> dict:
    """(a) the GAN step: a chunk of 4 across an lr_steps milestone against 4
    eager steps, launches, the kernels inside a replay, timing; (b)
    D_update_ratio 2; (c) the planted frozen-lr fault."""
    per_forward = EXPECTED_PER_FORWARD
    batches = dispatch_batches(DISPATCH_CHUNK + 1)
    graph_m, eager_m = dispatch_models(tmp / "gan", "train_explorable_SR.json", lr_steps=[3])
    start = {n: t.clone() for n, t in train_tensors(eager_m)}
    per_step = []
    for i in range(DISPATCH_CHUNK):
        eager_m.feed_data(batches[i])
        _, c, _ = counted(lambda: eager_m.optimize_parameters(i + 1))
        per_step.append(c)
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    _, chunk_counts, chunk_s = counted(
        lambda: graph_m.optimize_parameters_chunk(1, train_cli.stack_chunk(batches[:DISPATCH_CHUNK])))
    pool_gib = (torch.cuda.memory_reserved() - r0) / 2**30
    held, how = same_training(graph_m, eager_m, start, bands)
    (graph,) = graph_m._step_graphs.steps
    check(held and graph_m.step == eager_m.step == DISPATCH_CHUNK,
          f"phase 13 GAN step B{B} x HR{TRAIN_HR}, full width: a chunk of {DISPATCH_CHUNK} (steps_per_dispatch "
          f"{DISPATCH_CHUNK}, across the lr_steps milestone at 3) replayed as the step's CUDA graph == "
          f"{DISPATCH_CHUNK} eager steps from the same state: G, D, Adam moments and the last metrics {how} "
          f"(l_g {graph_m.get_current_losses()['l_g']:.6f}); chunk {chunk_s:.2f} s with capture "
          f"{graph.capture_seconds:.2f} s")
    want = {k: v * DISPATCH_CHUNK for k, v in per_forward.items()}
    check(chunk_counts == want and all(c == per_forward for c in per_step),
          f"phase 13 GAN launches: the chunk {chunk_counts} == {want}, each eager step {per_step[0]} == "
          f"{per_forward} (the graph's replays add what its capture counted)")
    graph_m.feed_data(batches[DISPATCH_CHUNK])
    _, replay_counts, _ = counted(lambda: graph_m.optimize_parameters(DISPATCH_CHUNK + 1))
    check(replay_counts == per_forward, f"phase 13 GAN launches of one replay {replay_counts} == {per_forward}")
    eager_m.feed_data(batches[DISPATCH_CHUNK])
    steps = iter(range(DISPATCH_CHUNK + 2, 10**6))
    k_replay, split = traced(tmp, "gan_replay", lambda: graph_m.optimize_parameters(next(steps)),
                             lambda: graph_m.optimize_parameters(next(steps)))
    k_eager, _ = traced(tmp, "gan_eager", lambda: eager_m.optimize_parameters(next(steps)),
                        lambda: eager_m.optimize_parameters(next(steps)))
    want_k = {"rdb5c_tc_kernel": per_forward["rdb5c"],
              "conv_tc_kernel": per_forward["conv3x3"] + per_forward["upsample2x_conv3x3"]}
    check(k_replay == k_eager == want_k and split["graph_launches"] >= 1,
          f"phase 13 profiler trace of one GAN replay: kernel events {k_replay} == one eager step's {k_eager} == "
          f"{want_k}; {split['graph_launches']} graph launch(es), {split['launches']} launch calls in all")

    # timing in turns: the graph, the eager kernel path, the bf16 plain path (eager), pipeline included
    from esr_tpu_torch.models.sr_model import _pipeline

    g = eager_m.g_module
    plain = make_gan_train_step(lambda x, zz: plain_forward(g, x, zz, torch.bfloat16), eager_m.d_module,
                                eager_m.f_module, eager_m.cem, _pipeline(eager_m.opt, SCALE, NZ, None),
                                eager_m.opt["train"], eager_m.g_opt, eager_m.d_opt, eager_m.schedulers["G"],
                                step_keyed(eager_m.schedulers["D"]))
    hr_dev = torch.from_numpy(batches[DISPATCH_CHUNK]["HR"]).cuda()
    seed = eager_m._rng_seed
    from esr_tpu_torch.models.base_model import step_generator

    paths = {"graph": graph_m.optimize_parameters, "eager kernels": eager_m.optimize_parameters,
             "bf16 plain": lambda s: plain(hr_dev, step_generator(seed, s), s)}
    peak = {}
    for name, fn in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        fn(next(steps))
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - a0) / 2**30
    ms, turns = step_turns(paths, steps)
    busy = split["device_busy_ms"]
    for name, m in ms.items():
        print(f"phase 13 GAN step B{B} x HR{TRAIN_HR} ({name}): {m:.2f} ms/step "
              f"({', '.join(f'{v:.2f}' for v in turns[name])}), {1e3 / m:.2f} steps/s on {card}", flush=True)
    print(f"phase 13 GAN graph: device busy {busy:.2f} ms in one replay (trace), idle "
          f"{100 - 100 * busy / ms['graph']:.1f}% of the unprofiled step; memory: the graph's pool holds "
          f"{pool_gib:.2f} GiB reserved (capture and chunk); one step's peak allocated above its start: graph "
          f"{peak['graph']:.2f} GiB, eager {peak['eager kernels']:.2f} GiB, bf16 plain {peak['bf16 plain']:.2f} GiB; capture "
          f"{graph.capture_seconds:.2f} s; graph / eager {ms['graph'] / ms['eager kernels']:.3f}, graph / bf16 plain "
          f"{ms['graph'] / ms['bf16 plain']:.3f} of the time per step", flush=True)
    del graph_m, eager_m, plain, paths
    release_memory()

    # D_update_ratio 2, D_init_iters 1: G updates at steps 2 and 4 only, two graphs (do_g False / True)
    graph_m, eager_m = dispatch_models(tmp / "gan_ratio", "train_explorable_SR.json", D_update_ratio=2,
                                       D_init_iters=1)
    start = {n: t.clone() for n, t in train_tensors(eager_m)}
    for i in range(DISPATCH_CHUNK):
        eager_m.feed_data(batches[i])
        eager_m.optimize_parameters(i + 1)
    graph_m.optimize_parameters_chunk(1, train_cli.stack_chunk(batches[:DISPATCH_CHUNK]))
    held, how = same_training(graph_m, eager_m, start, bands)
    check(held and len(graph_m._step_graphs.steps) == 2 and graph_m.g_opt.count == 2 and graph_m.d_opt.count == 4,
          f"phase 13 GAN chunk of {DISPATCH_CHUNK} with D_update_ratio 2, D_init_iters 1 (two graphs: G's update "
          f"skipped / made) == eager: {how}; Adam counts G {graph_m.g_opt.count}, D {graph_m.d_opt.count}")
    del graph_m, eager_m
    release_memory()

    # the planted fault: the learning rate frozen as a Python float at capture
    fault = frozen_lr_adam()
    saved = {k: getattr(Adam, k) for k in fault}
    graph_m, eager_m = dispatch_models(tmp / "gan_fault", "train_explorable_SR.json", lr_steps=[3])
    start = {n: t.clone() for n, t in train_tensors(eager_m)}
    for i in range(DISPATCH_CHUNK):
        eager_m.feed_data(batches[i])
        eager_m.optimize_parameters(i + 1)
    try:
        for k, fn in fault.items():
            setattr(Adam, k, fn)
        graph_m.optimize_parameters_chunk(1, train_cli.stack_chunk(batches[:DISPATCH_CHUNK]))
    finally:
        for k, fn in saved.items():
            setattr(Adam, k, fn)
    held, how = same_training(graph_m, eager_m, start, bands)
    check(not held, f"phase 13 planted fault, Adam's learning rate a Python float frozen at capture, across the "
          f"milestone: graph vs eager {how}: the check fails it")
    del graph_m, eager_m
    release_memory()
    return chunk_counts


def dispatch_sr(tmp: Path, card: str, bands: dict) -> dict:
    """The SR (PSNR) step in short: a chunk of 3 against 3 eager steps,
    launches of a replay, timing against the eager and bf16 plain paths."""
    from esr_tpu_torch.models.base_model import step_generator
    from esr_tpu_torch.models.sr_model import _pipeline, make_sr_train_step

    per_forward = EXPECTED_PER_FORWARD
    batches = dispatch_batches(4)
    graph_m, eager_m = dispatch_models(tmp / "sr", "train_RRDB_PSNR.json")
    start = {n: t.clone() for n, t in train_tensors(eager_m)}
    for i in range(3):
        eager_m.feed_data(batches[i])
        eager_m.optimize_parameters(i + 1)
    _, counts, secs = counted(lambda: graph_m.optimize_parameters_chunk(1, train_cli.stack_chunk(batches[:3])))
    held, how = same_training(graph_m, eager_m, start, bands)
    graph_m.feed_data(batches[3])
    _, replay, _ = counted(lambda: graph_m.optimize_parameters(4))
    (graph,) = graph_m._step_graphs.steps
    check(held and counts == {k: 3 * v for k, v in per_forward.items()} and replay == per_forward,
          f"phase 13 SR step B{B} x HR{TRAIN_HR}: a chunk of 3 as graph replays == 3 eager steps, {how}; launches "
          f"{counts}, one replay {replay}; chunk {secs:.2f} s, capture {graph.capture_seconds:.2f} s")
    eager_m.feed_data(batches[3])
    g = eager_m.g_module
    no_z = lambda x: x.new_zeros(x.shape[:-1] + (0,))  # noqa: E731 — the SR generator takes no Z channel
    plain = make_sr_train_step(lambda x, zz: plain_forward(g, x, no_z(x), torch.bfloat16),
                               _pipeline(eager_m.opt, SCALE, 0, None), eager_m.g_opt,
                               step_keyed(eager_m.schedulers["G"]))
    hr_dev = torch.from_numpy(batches[3]["HR"]).cuda()
    seed = eager_m._rng_seed
    steps = iter(range(5, 10**6))
    paths = {"graph": graph_m.optimize_parameters, "eager kernels": eager_m.optimize_parameters,
             "bf16 plain": lambda s: plain(hr_dev, step_generator(seed, s))}
    ms, turns = step_turns(paths, steps)
    _, split = traced(tmp, "sr_replay", lambda: graph_m.optimize_parameters(next(steps)),
                      lambda: graph_m.optimize_parameters(next(steps)))
    for name, m in ms.items():
        print(f"phase 13 SR step B{B} x HR{TRAIN_HR} ({name}): {m:.2f} ms/step "
              f"({', '.join(f'{v:.2f}' for v in turns[name])}) on {card}", flush=True)
    print(f"phase 13 SR graph: device busy {split['device_busy_ms']:.2f} ms in one replay, idle "
          f"{100 - 100 * split['device_busy_ms'] / ms['graph']:.1f}% of the unprofiled step", flush=True)
    del graph_m, eager_m, plain, paths
    release_memory()
    return counts


def dispatch_z(tmp: Path, pth: str, card: str) -> dict:
    """The Z search at the explorer's 40 x 40 LR selection (bucket 64): a
    64-step search as graph replays against the same search eagerly (trace,
    Z and best Z), ms per Z step of the graph, the eager kernel path and the
    bf16 plain path, a click's wall with its capture and a repeat click's."""
    sess = explore_session(tmp, pth)
    g, cem = sess.g, sess.cem
    lr = torch.from_numpy(sess.lr_img).to(sess.device)
    y, x, size = bucket_crop(EXPLORE_BOX, EXPLORE_LR, EXPLORE_LR, SCALE)
    lr_c = lr[:, y : y + size, x : x + size].contiguous()
    mask = torch.zeros(size * SCALE, size * SCALE, device=lr.device)
    mask[(EXPLORE_BOX[0] - y) * SCALE : (EXPLORE_BOX[2] - y) * SCALE,
         (EXPLORE_BOX[1] - x) * SCALE : (EXPLORE_BOX[3] - x) * SCALE] = 1.0
    z0 = torch.from_numpy(np.random.default_rng(15).uniform(-0.5, 0.5, (1, size, size, NZ))
                          .astype(np.float32)).to(lr.device)
    obj = explore_obj.variance_objective(1.0)

    def search(forward, graphed: bool, n: int):
        s = ZSearch(forward, lr_c, z0, mask, obj.fn, obj.aux)
        s.step.enabled = graphed
        s.set_round(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = s.run(n, lambda count: 0.1)
        torch.cuda.synchronize()
        return s, losses, (time.perf_counter() - t0) * 1e3 / n

    se, le, ms_eager = search(sess.forward, False, Z_STEPS)
    (sg, lg, ms_first), counts, _ = counted(lambda: search(sess.forward, True, Z_STEPS))
    equal = torch.equal(lg, le) and torch.equal(sg.z, se.z) and torch.equal(sg.best_z, se.best_z)
    want = {k: v * Z_STEPS for k, v in EXPECTED_PER_FORWARD.items()}
    check(equal and counts == want,
          f"phase 13 Z search, {Z_STEPS} steps on the 64x64 LR crop of the 40x40 selection (variance +): graph "
          f"replays == eager, loss trace, Z and best Z bit for bit {equal} (loss {float(lg[0]):.6f} -> "
          f"{float(lg[-1]):.6f}); launches {counts} == {want}")
    sg.load(lr_c, z0, mask, obj.aux)
    sg.set_round(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = sg.run(Z_STEPS, lambda count: 0.1)
    torch.cuda.synchronize()
    ms_graph = (time.perf_counter() - t0) * 1e3 / Z_STEPS
    check(torch.equal(again, lg), "phase 13 Z search on the same buffers again (reset, no capture): the same trace")
    _, _, ms_plain = search(lambda l_, z_: cem.project(plain_forward(g, l_, z_, torch.bfloat16), l_), False, 8)
    sg.load(lr_c, z0, mask, obj.aux)
    _, split = traced(tmp, "z_replays", lambda: sg.run(2, lambda c: 0.1), lambda: sg.run(8, lambda c: 0.1))
    # clicks through the session: the first at this bucket captures, the repeat replays
    sess.set_search_strength(n_steps=Z_STEPS)
    sess.select_rect(*(v * SCALE for v in EXPLORE_BOX))
    clicks = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.increase_variance()
        torch.cuda.synchronize()
        clicks.append(time.perf_counter() - t0)
    res = max_err(cem.downsample(torch.from_numpy(sess.current_sr()).to(lr.device)), lr)
    check(res <= CEM_TOL, f"phase 13 variance clicks through the graphed search: CEM residual {res:.3g} <= {CEM_TOL}")
    busy = split["device_busy_ms"] / 8
    print(f"phase 13 Z step, 64x64 LR crop (HR 256), on {card}: graph {ms_graph:.2f} ms/step (the first search, "
          f"capture included: {ms_first:.2f}), eager kernels {ms_eager:.2f}, bf16 plain (eager, 8 steps) "
          f"{ms_plain:.2f}; graph device busy {busy:.2f} ms a step, idle {100 - 100 * busy / ms_graph:.1f}%; "
          f"capture {sg.step.capture_seconds:.2f} s; a {Z_STEPS}-step variance click {clicks[0] * 1e3:.1f} ms with "
          f"its capture, a repeat click {clicks[1] * 1e3:.1f} ms", flush=True)
    return counts


def dispatch_cli(tmp: Path) -> dict:
    """The train CLI with steps_per_dispatch 3, print_freq 4, save_freq 5 (5
    steps: chunks [1-3], [4], [5]) against the per-step run: the same log
    rows and checkpoints."""
    runs = {}
    for k in (1, 3):
        opt = train_options(tmp / f"cli_{k}", "dispatch_cli", "train_explorable_SR.json", None, niter=5,
                            steps_per_dispatch=k)
        opt["logger"] = {"print_freq": 4, "save_checkpoint_freq": 5}
        _, counts, secs = run_train(tmp / f"cli_{k}", opt)
        exp = tmp / f"cli_{k}" / "experiments" / "dispatch_cli"
        runs[k] = (train_csv(tmp / f"cli_{k}", "dispatch_cli"), sorted(p.name for p in (exp / "models").iterdir()),
                   train_state(tmp / f"cli_{k}", "dispatch_cli", 5), counts, secs)
    (rows1, models1, st1, c1, s1), (rows3, models3, st3, c3, s3) = runs[1], runs[3]
    same = all(torch.equal(v, st3[n]["net"][key]) for n in ("G", "D") for key, v in st1[n]["net"].items())
    want = {k: v * 5 for k, v in EXPECTED_PER_FORWARD.items()}
    check(rows1 == rows3 and [int(r["step"]) for r in rows3] == [4] and models1 == models3 and same
          and c1 == c3 == want,
          f"phase 13 train CLI, steps_per_dispatch 3 (print 4, save 5, 5 steps: chunks 1-3, 4, 5) == the per-step "
          f"run: log rows at {[int(r['step']) for r in rows3]}, checkpoints {models3}, the states at 5 bit for bit "
          f"{same}; launches {c3} == {want}; {s3:.1f} s against {s1:.1f} s")
    return c3


def phase_dispatch(tmp: Path, pth: str, card: str, bands: dict) -> dict[str, dict]:
    """Phase 13: the train steps and the Z step as CUDA graphs, against
    eager, at full width; returns the launches by path."""
    t0 = time.perf_counter()
    (tmp / "dispatch").mkdir(parents=True, exist_ok=True)
    torch.backends.cudnn.deterministic = True  # graph against eager, bit for bit
    try:
        # each path's launches: its graphed run, counters set to 0 just before and read just after
        paths, secs = {}, {}
        for name, fn in (("dispatch_gan", lambda: dispatch_gan(tmp / "dispatch", card, bands)),
                         ("dispatch_sr", lambda: dispatch_sr(tmp / "dispatch", card, bands)),
                         ("dispatch_z", lambda: dispatch_z(tmp / "dispatch", pth, card)),
                         ("dispatch_cli", lambda: dispatch_cli(tmp / "dispatch"))):
            t1 = time.perf_counter()
            paths[name] = fn()
            secs[name] = time.perf_counter() - t1
    finally:
        torch.backends.cudnn.deterministic = False
    total = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
    check(total <= 90.0, f"phase 13 ran in {total:.1f} s <= 90 s ({parts})")
    return paths


def main() -> int:
    env = phase_environment()
    phase_build()
    rows = phase_kernels()
    by_path = {"forward": phase_requests()}
    phase_timing(env["card"], rows)
    by_path["forward_graph"] = phase_forward_graphs(env["card"])
    f32_forward = phase_f32_forward(env["card"])
    by_path.update(phase_widths_forward())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        pth = str(tmp / "G.pth")
        opt = {"network_G": {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ}, "scale": SCALE}
        torch.save(define_G(opt, device="cuda", seed=0).state_dict(), pth)
        by_path.update(phase_eval(tmp, pth))
        by_path["serve"] = phase_serve(tmp, pth)
        train_paths = phase_train(tmp)
        bands = {"grads": train_paths.pop("_grad_bands"), "losses": train_paths.pop("_loss_bands")}
        by_path["explore"] = phase_explore(tmp, pth)
        by_path.update(phase_blind(tmp, pth, rows, env["card"]))
        by_path.update(phase_parallel(tmp, pth, env["card"], bands))
        script_paths, f32_paths = phase_scripts(tmp, pth, env["card"])
        by_path.update(script_paths)
        by_path.update(phase_dispatch(tmp, pth, env["card"], bands))
    rdb_train = train_paths.pop("_rdb5c_train_ms", None)
    by_path.update(train_paths)
    for r in rows:
        if r["name"] == "conv_f32":  # the f32 route's main path is the f32 forward (phase 5)
            counts = {k: v for k, v in f32_forward["launches"].items() if k in F32_PER_FORWARD}
            r.update(launches=counts["conv_f32_kernel"], launches_by_path={"f32_forward": counts, **f32_paths},
                     **{k: f32_forward[k] for k in ("ms", "plain_ms", "kernel_device_ms", "tf32_control_err")})
            r["max_abs_err"] = max(r["max_abs_err"], f32_forward["max_abs_err"])
            check(all(counts.values()), f"conv_f32 launched on the f32 forward's every counter: {counts}")
            check(all(c["conv_f32_kernel"] for c in f32_paths.values()),
                  f"conv_f32_kernel launched on every f32 path of phase 12: {f32_paths}")
            continue
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        # SRResNet runs no RDB and upsamples by pixel shuffle: zero there by design
        zero = {p for p, names in ZERO_BY_DESIGN.items() if r["name"] in names}
        check(all((n == 0) == (p in zero) for p, n in r["launches_by_path"].items()),
              f"{r['name']} launched on every path that runs it and on none of {sorted(zero)}: {r['launches_by_path']}")
        if r["name"] == "rdb5c" and rdb_train is not None:
            r["train_shape"] = dict(rdb_train, shape="x (16,32,32,64) bf16, the train step's LR 32x32")
    print(json.dumps({"kernels": rows, "card": env["card"]}), flush=True)
    print(env["card"], flush=True)
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed:", *FAILURES, sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["kind"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
