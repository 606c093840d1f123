"""The scripts, the profiler and the probes on the card.

The profiler (``utils/profiler``): a ``trace`` of three flagship forwards,
two in ``annotate`` regions, holds 2 x 69 ``rdb5c_tc_kernel`` events
launched in the regions, and does not count the port's spans as device
work; in a trace of one editor click every launch call has its kernel. The
scripts: ``explore_bench`` (one region, 2 repeat clicks, 32 steps, no
adaptive imprint), ``ensemble_bench --n 2``, ``precision_ladder`` (the bf16
kernels' PSNR against the f32 plain oracle within 1 dB of the bf16 plain
path's), ``parity_eval`` (f32) on the seed-0 ``.pth`` in the reference's old
key layout over two 1/f PNGs, the PSNR of the new layout's;
``quickstart --niter 4``; the int8 / FP8 probe at one conv shape and the
RDB kernel under tile hints at the DIV2K eval shape. (``graft_entry``'s
forward: ``test_torch_cuda.py``.)
"""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from esr_tpu_torch.cem import CEMConf, make_cem
from esr_tpu_torch.data.util import save_img
from esr_tpu_torch.models import define_G
from esr_tpu_torch.utils.profiler import annotate, trace
from torch_card import (ALL_COUNTERS, F32_TOL, GC, NB, NF, NZ, PSNR_MARGIN_DB, SCALE, counted, cuda, g0_pth,  # noqa: F401
                        old_layout, per_forward, region_kernels, span_split)

BF16_NAMES = ("rdb5c", "conv3x3", "upsample2x_conv3x3")
F32_NAMES = ("rdb5c_f32", "conv3x3_f32", "upsample2x_conv3x3_f32", "conv_f32_kernel")


def split_counts(launches: dict) -> tuple[dict, dict]:
    """ALL_COUNTERS' launches as (the bf16 kernels', the f32 route's)."""
    return {k: launches[k] for k in BF16_NAMES}, {k: launches[k] for k in F32_NAMES}


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_profiler_trace_of_forwards_in_regions(cuda, tmp_path):
    """``graft_entry.entry()``'s forward (B2 x LR 64) three times in a
    ``trace``, the first outside the regions (the first ~40 kernels of a
    session went missing from its trace on the H100): 3 x 69 / 4 / 2
    launches; 138 ``rdb5c_tc_kernel`` events launched in the 2 regions (by
    correlation id: the forward is a CUDA graph, its kernels carry the graph
    launch's); the port's spans (record_function ranges inside ``trace()``)
    are not among the profile's device work."""
    from esr_tpu_torch.graft_entry import entry

    fn, (lr, z) = entry(device="cuda")
    names = ("flagship_forward_0", "flagship_forward_1")

    def traced():
        with trace(str(tmp_path)) as prof:
            fn(lr, z)
            torch.cuda.synchronize()
            for name in names:
                with annotate(name):
                    fn(lr, z)
            torch.cuda.synchronize()
        return prof

    prof, launches = counted(traced)
    assert launches == per_forward(3)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(region_kernels(events, name)["rdb5c_tc_kernel"] for name in names) == 2 * 3 * NB
    ev = prof.key_averages()
    ranges = set(names) | {e.key for e in ev if getattr(e, "is_user_annotation", False)}
    device_keys = {e.key for e in ev if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges}
    assert not device_keys & {"eval.forward", "graphs.replay", *names}


@pytest.mark.cuda
def test_cuda_profiler_trace_of_a_click_keeps_every_kernel(cuda):
    """One variance click (8 Z steps) of the flagship editor at LR 64 in an
    ``annotate`` region of a ``trace`` that a click outside the region opens:
    every launch call of the region has its kernel in the trace."""
    from esr_tpu_torch.explore.session import ExplorationSession

    opt = {"network_G": {"nf": NF, "nb": NB, "gc": GC, "num_latent_channels": NZ}, "scale": SCALE, "bf16": True}
    g = define_G(opt, device="cuda", seed=0)
    lr = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
    sess = ExplorationSession(g, make_cem(CEMConf(scale=SCALE), device="cuda"), lr, n_steps=8)
    sess.select_rect(0, 0, 40, 40)
    sess.increase_variance()  # the first click at this bucket
    sess.increase_variance()
    with tempfile.TemporaryDirectory(prefix="trace_click_") as log_dir:
        with trace(log_dir):
            sess.increase_variance()
            torch.cuda.synchronize()
            with annotate("variance_click"):
                sess.increase_variance()
        split = span_split(json.loads((Path(log_dir) / "trace.json").read_text())["traceEvents"], "variance_click")
    assert split["launches"] > 0 and split["dropped"] == 0 and split["kernels"] == split["launches"], split


@pytest.mark.cuda
def test_cuda_explore_bench(cuda):
    """``explore_bench --regions 10 --iters 2 --n_steps 32 --no-adaptive``:
    its platform the device's name, launches on every bf16 kernel, positive
    click and render times."""
    from esr_tpu_torch.scripts import explore_bench

    line, launches = counted(lambda: explore_bench.main(["--regions", "10", "--iters", "2", "--n_steps", "32",
                                                         "--no-adaptive", "--device", "cuda"]))
    assert line["platform"] == torch.cuda.get_device_name(0)
    assert all(launches.values()) and line["clicks"][0]["click_s"] > 0 and line["render_s"]["repeat"] > 0, launches


@pytest.mark.cuda
def test_cuda_ensemble_bench(cuda):
    """``ensemble_bench --n 2``: launches on every bf16 kernel, the x8
    ensemble costing more than the plain forward, both CEM residuals within
    1e-5, a finite PSNR delta."""
    from esr_tpu_torch.scripts import ensemble_bench

    line, launches = counted(lambda: ensemble_bench.main(["--n", "2", "--device", "cuda"]))
    assert all(launches.values()) and line["cost_factor"] > 1 and np.isfinite(line["psnr_delta_db"])
    assert max(line["plain"]["cem_residual"], line["ensemble"]["cem_residual"]) <= 1e-5


@pytest.mark.cuda
def test_cuda_precision_ladder(cuda):
    """The ladder in one process on the seeded flagship (LR 64 x 48): the bf16
    kernels' PSNR against the f32 plain oracle at most PSNR_MARGIN_DB below
    the bf16 plain path's; the f32 kernels within F32_TOL of it, on the f32
    route (conv_f32_kernel launched); every bf16 kernel launched."""
    from esr_tpu_torch.scripts import precision_ladder

    out, launches = counted(lambda: precision_ladder.run_variants(None, device="cuda"), ALL_COUNTERS)
    m = {v: precision_ladder.metrics(out[v], out["f32_plain"]) for v in ("bf16_kernels", "bf16_plain", "f32_kernels")}
    assert m["bf16_kernels"]["psnr_db"] >= m["bf16_plain"]["psnr_db"] - PSNR_MARGIN_DB
    assert m["f32_kernels"]["max"] <= F32_TOL
    bf16, f32 = split_counts(launches)
    assert all(bf16.values()) and f32["conv_f32_kernel"] > 0, launches


@pytest.mark.cuda
def test_cuda_parity_eval_reads_the_old_layout(g0_pth, tmp_path):
    """``parity_eval`` (f32, TF32 off) on two 1/f PNGs (HR 128 x 96 and
    96 x 128): on the f32 route (2 x 69 RDBs, conv_f32_kernel launched), no
    bf16 launch; the seed-0 ``.pth`` in the reference's old key layout (in a
    ``{"state_dict": ...}`` wrapper) gives the new layout's PSNR to 1e-3 dB,
    finite, with the Z channels read from conv_first."""
    from esr_tpu_torch.scripts import parity_eval, precision_ladder

    hr_dir = tmp_path / "parity_hr"
    for i, (h, w) in enumerate(((128, 96), (96, 128))):
        save_img((precision_ladder.one_over_f_image(h, w, seed=20 + i) * 255).round().astype(np.uint8),
                 str(hr_dir / f"img{i}.png"))
    old = tmp_path / "G_old_layout.pth"
    torch.save({"state_dict": old_layout(torch.load(g0_pth, map_location="cpu", weights_only=True))}, old)
    reports = {}
    for name, path in (("new", g0_pth), ("old", str(old))):
        reports[name], launches = counted(lambda p=path, n=name: parity_eval.run_parity_eval(
            p, str(hr_dir), out=str(tmp_path / f"parity_{n}.json"), device="cuda"), ALL_COUNTERS)
        bf16, f32 = split_counts(launches)
        assert not any(bf16.values()) and f32["rdb5c_f32"] == 2 * 3 * NB and f32["conv_f32_kernel"] > 0, launches
    assert abs(reports["old"]["psnr"] - reports["new"]["psnr"]) <= 1e-3 and np.isfinite(reports["new"]["psnr"])
    assert reports["old"]["num_latent_channels"] == NZ


@pytest.mark.cuda
def test_cuda_quickstart(cuda, tmp_path):
    """``quickstart --niter 4`` (a toy net, nf 8, f32): trained, evaluated
    and edited on the card, on the f32 route."""
    from esr_tpu_torch.scripts import quickstart

    edited, launches = counted(lambda: quickstart.main(["--root", str(tmp_path), "--niter", "4", "--device", "cuda"]),
                               ALL_COUNTERS)
    assert Path(edited).exists() and (tmp_path / "experiments" / "quickstart" / "models" / "latest_G.pth").exists()
    assert split_counts(launches)[1]["conv_f32_kernel"] > 0


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_int8_probe(cuda):
    """At one conv shape (64 x 320) and the 8192^3 matmul: every rate
    positive, the bf16 im2col GEMM within 2^-6 of the f32 conv, the int8 /
    FP8 errors finite and below 0.25 of its largest value."""
    from esr_tpu_torch.ops import int8_probe

    res = int8_probe.run_probes(shapes=((64, 320),), device="cuda")
    errs = {k: v for k, v in res.items() if k.endswith("_max_rel_err")}
    assert all(v > 0 for k, v in res.items() if k.endswith("_tfs"))
    assert errs["bf16_conv_64x320_max_rel_err"] <= 2.0**-6 and all(np.isfinite(v) and v <= 0.25 for v in errs.values())


@pytest.mark.cuda
def test_cuda_tiled_probe(cuda):
    """The tensor-core RDB kernel at the DIV2K eval shape (1 x 336 x 504 x
    64) is within 0.125 of the bf16 plain block; both are timed."""
    from esr_tpu_torch.ops.cuda import tiled_probe

    res = tiled_probe.run_tiled_probe(device="cuda")
    assert res["max_abs_err"] <= 0.125 and res["kernel_ms"] > 0 and res["plain_ms"] > 0, res
