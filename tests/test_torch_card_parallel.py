"""The parallel axes at the flagship's width and depth on the card: 2 ranks
sharing it over gloo (spawned, a file store; NCCL needs a GPU per rank),
seeded weights, bf16, CEM matmul, B16 x LR 128.

(a) ``eval_spatial: 2`` at halos 32 and 16 (raw G rows a halo from the seam
against the whole-image kernel forward bit for bit, CEM residual, PSNR
against f32 plain); (b) ``eval_tp: 2`` (PSNR; each row-parallel conv's sum
of partials against the f32 conv, a bound that a dropped partial fails);
(c) ``eval_pp: 2`` at nb 24, 8 microbatches (the single-rank forward bit
for bit); (d) ``dist_eval`` in the ranks and under ``python -m
torch.distributed.run --nproc_per_node 2 -m esr_tpu_torch.test`` (the
one-rank batched metrics; rank 0 alone reports and writes); (e) a ``dist``
GAN step, 2 x B8 against one process at B16, and (f) one of
``train_spatial``, ``train_tp`` and ``train_pp`` (nb 24): losses and G's
gradients within the GAN step's bands (``torch_card.gan_grads``) of one
process's, G and D bit-identical on both ranks, each band shown to fail a
planted fault (a TP backward scaled by T, a halo of 0, a dropped
microbatch); (g) ``python -m esr_tpu_torch.parallel.multihost``, 2
processes against 1. Every rank reports its launches.
"""

import contextlib
import hashlib
import json
import math
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esr_tpu_torch import test as eval_cli
from esr_tpu_torch.device import full_f32
from esr_tpu_torch.models import create_model, define_G
from esr_tpu_torch.options import parse
from torch_card import (B, CEM_TOL, EXPECTED_PER_FORWARD, GC, GRAD_BAND_FLOOR, LR, METRIC_TOL, NB, NF, NOISE_GRADS, NZ,  # noqa: F401
                        PSNR_MARGIN_DB, REPO, SCALE, card, counted, cuda, flagship_options, g0_pth, gan_grads,
                        hr_batches, max_err, plain_forward, psnr, rel_l2, run_cli, train_options)

PAR_WIDTHS = {"nf": NF, "nb": NB, "gc": GC}  # the flagship's
PAR_NB_PP = 24  # the pipeline's depth: the flagship's 23 does not divide over 2 stages
N_MICRO = 8  # the pipeline's microbatches at B16
# eval_spatial halos: at LR 128 a halo of 32 makes each window the whole image, 16 windows of 96 rows
PAR_HALOS = (32, 16)
PAR_TRAIN_HALO = 4  # train_spatial at LR 32: windows of 24 of the 32 rows
TP_CONV_BOUND = 2.0**-6  # eval_tp: a row-parallel conv's sum against the f32 conv, relative max error
TP_CONVS = {"rdb5c": 0, "conv3x3": 4 + 5 * 3 * NB, "upsample2x_conv3x3": 2}


def par_eval_options(tmp: Path, pth: str, name: str, nb: int | None = None, datasets=None, **extra) -> dict:
    opt = flagship_options(tmp, pth, name, datasets or {}, dist_backend="gloo", **extra)
    opt["network_G"].update(PAR_WIDTHS if nb is None else dict(PAR_WIDTHS, nb=nb))
    return opt


def par_train_options(tmp: Path, name: str, nb: int | None = None, **extra) -> dict:
    opt = train_options(tmp, name, "train_explorable_SR.json", None, niter=2)
    opt["network_G"].update(PAR_WIDTHS if nb is None else dict(PAR_WIDTHS, nb=nb))
    opt.update(dist_backend="gloo", **extra)
    return opt


def rank() -> int:
    from esr_tpu_torch.parallel import comm

    return comm.world()[0]


def par_gan_step(opt: dict, hr_u8: torch.Tensor, device, fault=None) -> dict:
    """One GAN step of the trainer ``opt`` builds on this rank's rows of the
    fixed host batch: losses, G's gradients (full width, rank 0), launches,
    a digest of G and D after a second step."""
    from esr_tpu_torch.parallel import tensor as ptensor

    model = create_model(parse(opt, is_train=True), device=device)
    seen, step = [], model.g_opt.step

    def record(grads, lr, sq_sum=None):
        seen.append([g.detach().float() for g in grads])
        step(grads, lr, sq_sum)

    model.g_opt.step = record
    i, n = model.data_shard()
    rows = hr_u8[i * hr_u8.shape[0] // n : (i + 1) * hr_u8.shape[0] // n]
    with fault() if fault is not None else contextlib.nullcontext():
        model.feed_data({"HR": rows})
        _, launches = counted(lambda: model.optimize_parameters(1))
        losses = model.get_current_losses()
        model.feed_data({"HR": rows})
        model.optimize_parameters(2)
        torch.cuda.synchronize()
    names = [nm for nm, _ in model.g_module.named_parameters()]
    grads = dict(zip(names, ptensor.full_param_tensors(model.g_module, seen[0])))
    h = hashlib.sha256()
    for st in (model._full_state(model.g_module), model.d_module.state_dict()):
        for k in sorted(st):
            h.update(k.encode())
            h.update(st[k].detach().float().cpu().numpy().tobytes())
    out = {"losses": losses, "counts": launches, "digest": h.hexdigest(), "shard": (i, n)}
    if rank() == 0:
        out["grads"] = {k: v.cpu() for k, v in grads.items()}
    return out


@torch.no_grad()
def par_forward(opt: dict, lr: torch.Tensor, z: torch.Tensor, device, raw_fn=None, fault=None, inspect=None) -> dict:
    """The eval forward ``opt`` builds (``create_model``), counted: the SR
    (and the raw G output ``raw_fn(model)`` gives) on rank 0, and the LR
    heights G ran on (a spatial window's). ``fault``: a context the forward
    runs in; ``inspect(model)``, called before it, returns a function whose
    dict joins the result after it."""
    model = create_model(parse(opt, is_train=False), device=device)
    after = inspect(model) if inspect is not None else None
    rows = set()
    hook = model.g_module.conv_first.register_forward_pre_hook(lambda m, a: rows.add(a[0].shape[1]))
    with fault() if fault is not None else contextlib.nullcontext():
        sr, launches = counted(lambda: model._forward(lr, z))
    hook.remove()
    out = {"counts": launches, "rows": sorted(rows), **(after() if after is not None else {})}
    raw = raw_fn(model) if raw_fn is not None else None
    if rank() == 0:
        out["sr"] = sr.cpu()
        out["raw"] = None if raw is None else raw.cpu()
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
    """One rank (``comm.spawn``): the sharded eval forwards (and eval_tp's
    with a planted fault), the eval CLI under dist_eval, and one GAN step of
    each train axis and of its planted fault; rank 0 returns the tensors,
    every rank its counts."""
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

    tp_opt = par_eval_options(tmp, spec["pth"], "par_tp", eval_tp=2)
    out["eval_tp"] = par_forward(tp_opt, lr, z, device, inspect=tp_convs)
    # the planted fault on 2 of the images (the conv check reads each conv alone; the sums through the host
    # shrink with the batch)
    out["eval_tp_fault"] = par_forward(tp_opt, lr[:2], z[:2], device, fault=dropped_partial, inspect=tp_convs)
    out["eval_pp"] = par_forward(par_eval_options(tmp, spec["pth_pp"], "par_pp", nb=PAR_NB_PP, eval_pp=2),
                                 lr, z, device)
    path = tmp / f"par_dist_eval_{comm.world()[0]}.json"
    path.write_text(json.dumps(spec["dist_eval_opt"]))
    res, launches = counted(lambda: eval_cli.main(["-opt", str(path), "--device", "cuda"]))
    out["dist_eval"] = {"metrics": res, "counts": launches}
    torch.cuda.empty_cache()

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
        out[name] = par_gan_step(opt, spec["hr_u8"], device, fault)
        torch.cuda.empty_cache()
    return out


@pytest.fixture(scope="module")
def par(g0_pth, tmp_path_factory):
    """The references in one process (the whole-image forwards, f32 and bf16
    plain, the one-process GAN steps, the one-rank batched eval) and the two
    ranks' results."""
    from esr_tpu_torch.parallel import comm

    card()
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(11)
    lr = torch.from_numpy(rng.random((B, LR, LR, 3), dtype=np.float32))
    z = torch.from_numpy(rng.uniform(-1, 1, (B, LR, LR, NZ)).astype(np.float32))
    pth_pp = str(tmp / "G_nb24.pth")
    torch.save(define_G({"network_G": dict(PAR_WIDTHS, nb=PAR_NB_PP, num_latent_channels=NZ), "scale": SCALE},
                        device="cuda", seed=0).state_dict(), pth_pp)
    hr_u8 = torch.from_numpy(hr_batches(1)[0]["HR"])
    datasets = {"test_1": {"name": "synthetic", "mode": "SYNTHETIC", "n_images": 4, "image_size": 512}}
    dist_eval_opt = par_eval_options(tmp, g0_pth, "par_dist_eval", datasets=datasets, num_random_Z=2, dist_eval=True,
                                     eval_batch=2)
    with torch.no_grad():
        model = create_model(parse(par_eval_options(tmp, g0_pth, "par_ref"), is_train=False), device="cuda")
        g, cem = model.g_module, model.cem
        lr_d, z_d = lr.cuda(), z.cuda()
        ref_raw = g(lr_d, z_d)
        ref = cem.project(ref_raw, lr_d)
        ref32 = cem.project(plain_forward(g, lr_d, z_d, torch.float32), lr_d)
        plain16 = cem.project(plain_forward(g, lr_d, z_d, torch.bfloat16), lr_d)
        out = {"tmp": tmp, "cem": cem, "lr": lr_d, "p_plain": psnr(plain16, ref32),
               "plain_rel": max_err(plain16, ref) / ref.abs().max().item(),
               "refs": {"raw": ref_raw.cpu(), "sr": ref.cpu(), "f32": ref32.cpu()}}
        del model, g, ref32, plain16
        model = create_model(parse(par_eval_options(tmp, pth_pp, "par_ref_pp", nb=PAR_NB_PP), is_train=False),
                             device="cuda")
        out["refs"]["pp"] = model._forward(lr_d, z_d).cpu()
        del model
    out["one"] = {name: par_gan_step(par_train_options(tmp / f"one_{name}", f"one_{name}", nb=nb), hr_u8, "cuda")
                  for name, nb in (("flagship", None), ("pp", PAR_NB_PP))}
    out["batched"], _ = run_cli(tmp, dict(dist_eval_opt, name="par_one_batched", dist_eval=False, eval_batch=4),
                                "--device", "cuda")
    out["dist_eval_opt"] = dist_eval_opt
    torch.cuda.empty_cache()
    spec = {"tmp": str(tmp), "pth": g0_pth, "pth_pp": pth_pp, "lr": lr, "z": z, "hr_u8": hr_u8,
            "dist_eval_opt": dist_eval_opt}
    out["ranks"] = comm.spawn(par_rank, 2, tmp / "store", args=(spec,), backend="gloo", timeout=900.0)
    return out


@pytest.mark.cuda
def test_cuda_parallel_ranks_on_the_card_over_gloo(par):
    """Explicitly gloo: NCCL cannot put two ranks on one GPU."""
    assert [r["backend"] for r in par["ranks"]] == ["gloo", "gloo"]
    assert all(r["device"].startswith("cuda") for r in par["ranks"])


@pytest.mark.cuda
@pytest.mark.parametrize("path,want", [
    ("eval_spatial32", EXPECTED_PER_FORWARD), ("eval_spatial16", EXPECTED_PER_FORWARD), ("eval_tp", TP_CONVS),
    ("eval_pp", {"rdb5c": 3 * PAR_NB_PP // 2 * N_MICRO, "conv3x3": 4, "upsample2x_conv3x3": 2}),
    ("train_dist", EXPECTED_PER_FORWARD), ("train_spatial", EXPECTED_PER_FORWARD), ("train_tp", TP_CONVS),
    ("train_pp", {"rdb5c": 2 * 3 * PAR_NB_PP // 2 * N_MICRO, "conv3x3": 4, "upsample2x_conv3x3": 2})])
def test_cuda_parallel_launches_per_rank(par, path, want):
    """Each rank's launches: a spatial window's forward the whole net's;
    eval_tp's and train_tp's RDB convs row-parallel on the conv kernel (345
    + 4), no RDB kernel; a pipeline stage's 36 RDBs a microbatch (twice in
    the train step: the recompute)."""
    assert [r[path]["counts"] for r in par["ranks"]] == [want, want]


@pytest.mark.cuda
@pytest.mark.parametrize("halo", PAR_HALOS)
def test_cuda_eval_spatial(par, halo):
    """eval_spatial 2: the CEM residual within CEM_TOL, PSNR against f32
    plain at most PSNR_MARGIN_DB below the bf16 plain path's; G ran on
    windows of LR 64 + 2 halo rows (at most the image); the raw G rows at
    least a halo from the seam equal the whole-image kernel forward's bit for
    bit."""
    a, refs = par["ranks"][0][f"eval_spatial{halo}"], par["refs"]
    assert max_err(par["cem"].downsample(a["sr"].cuda()), par["lr"]) <= CEM_TOL
    assert psnr(a["sr"], refs["f32"]) >= par["p_plain"] - PSNR_MARGIN_DB
    seam = LR // 2 * SCALE
    far = torch.cat([a["raw"][:, : seam - halo * SCALE], a["raw"][:, seam + halo * SCALE:]], 1)
    far_ref = torch.cat([refs["raw"][:, : seam - halo * SCALE], refs["raw"][:, seam + halo * SCALE:]], 1)
    assert a["rows"] == [min(LR, LR // 2 + 2 * halo)] and torch.equal(far, far_ref)


@pytest.mark.cuda
def test_cuda_eval_tp(par):
    """eval_tp 2: PSNR against f32 plain at most PSNR_MARGIN_DB below the
    bf16 plain path's, the CEM residual, the answer within twice the bf16
    plain path's relative distance from the kernel forward; each of the 345
    row-parallel convs' sum of partials within TP_CONV_BOUND of the f32 conv
    of the gathered weight on its input, on every rank; with rank 1's
    partial of the first conv dropped, that conv alone outside the bound."""
    r0, refs = par["ranks"][0], par["refs"]
    sr = r0["eval_tp"]["sr"]
    assert psnr(sr, refs["f32"]) >= par["p_plain"] - PSNR_MARGIN_DB
    assert max_err(par["cem"].downsample(sr.cuda()), par["lr"]) <= CEM_TOL
    assert max_err(sr, refs["sr"]) / refs["sr"].abs().max().item() <= 2 * par["plain_rel"]
    assert all(len(r["eval_tp"]["conv_rel"]) == 15 * NB for r in par["ranks"])
    assert max(max(r["eval_tp"]["conv_rel"]) for r in par["ranks"]) <= TP_CONV_BOUND
    f = r0["eval_tp_fault"]["conv_rel"]
    assert f[0] > TP_CONV_BOUND >= max(f[1:]), (f[0], max(f[1:]))


@pytest.mark.cuda
def test_cuda_eval_pp(par):
    """eval_pp 2 at nb 24, 8 microbatches: the single-rank forward bit for bit."""
    assert torch.equal(par["ranks"][0]["eval_pp"]["sr"], par["refs"]["pp"])


@pytest.mark.cuda
def test_cuda_dist_eval_in_the_ranks(par):
    """dist_eval over 2 ranks (4 images dealt 2 a rank, eval_batch 2, 3
    draws: 3 forwards a rank): rank 1 reports nothing; rank 0's metrics are
    the one-rank batched run's (CEM residual within CEM_TOL, the rest within
    the eval CLI's batched-vs-serial tolerances)."""
    d = [r["dist_eval"] for r in par["ranks"]]
    assert d[1]["metrics"] == {}
    for k, v in par["batched"]["synthetic"].items():
        got = d[0]["metrics"]["synthetic"].get(k, math.inf)
        if k == "cem_residual":
            assert got <= CEM_TOL
        else:
            assert abs(got - v) <= METRIC_TOL.get(k, 1e-3 * abs(v)), (k, got, v)
    assert [r["counts"] for r in d] == [{k: v * 3 for k, v in EXPECTED_PER_FORWARD.items()}] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("path,fault", [("train_dist", None), ("train_tp", "train_tp_fault"),
                                        ("train_spatial", "train_spatial_fault"), ("train_pp", "train_pp_fault")])
def test_cuda_parallel_gan_step(par, path, fault):
    """One GAN step at B16 x HR 128 over the ranks' rows: its losses within
    the GAN step's loss bands of one process's, G's gradients within its
    gradient bands (a name with no band, block 23 of the 24-block pipeline
    net, takes the trunk's widest), G and D bit-identical on both ranks; and
    the gradient band fails the planted fault (a TP backward scaled by T, a
    halo of 0 at the seam, the first microbatch's gradient dropped)."""
    bands = gan_grads().bands
    trunk = max((v for k, v in bands["grads"].items() if k.startswith("RRDB_trunk.")), default=GRAD_BAND_FLOOR)

    def worst_grad(got):
        return max(rel_l2(got[k], w) / bands["grads"].get(k, trunk if k.startswith("RRDB_trunk.") else GRAD_BAND_FLOOR)
                   for k, w in ref["grads"].items() if k not in NOISE_GRADS)

    ranks = par["ranks"]
    ref, got = par["one"]["pp" if path == "train_pp" else "flagship"], ranks[0][path]
    for k, v in ref["losses"].items():
        diff = abs(got["losses"][k] - v) / (1.0 if k in ("D_real", "D_fake") else max(abs(v), 1e-12))
        assert diff <= bands["losses"].get(k, GRAD_BAND_FLOOR), (k, diff)
    assert worst_grad(got["grads"]) <= 1.0
    assert len({r[path]["digest"] for r in ranks}) == 1
    if fault is not None:
        assert worst_grad(ranks[0][fault]["grads"]) > 1.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_cuda_dist_eval_under_torchrun(par):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    esr_tpu_torch.test`` with dist_eval over gloo: rc 0, one result line
    (rank 0 alone logs) with the one-rank batched PSNR and SSIM (printed to 4
    decimals), 4 images x 3 draws of PNGs (rank 0 alone writes)."""
    tmp = par["tmp"]
    path = tmp / "par_torchrun.json"
    path.write_text(json.dumps(dict(par["dist_eval_opt"], name="par_torchrun")))
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_port",
                          str(free_port()), "-m", "esr_tpu_torch.test", "-opt", str(path), "--save_images",
                          "--device", "cuda"], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=str(REPO))
    lines = [ln for ln in (run.stdout + run.stderr).splitlines() if "avg PSNR" in ln]
    m = re.search(r"avg PSNR: ([0-9.]+) dB, avg SSIM: ([0-9.]+)", lines[0]) if lines else None
    b = par["batched"]["synthetic"]
    assert run.returncode == 0 and len(lines) == 1 and m is not None, (run.stdout + run.stderr)[-3000:]
    assert abs(float(m.group(1)) - b["psnr"]) <= 1e-3 + 5e-5 and abs(float(m.group(2)) - b["ssim"]) <= 1e-4
    assert len(sorted((tmp / "results" / "par_torchrun" / "synthetic").glob("*.png"))) == 4 * 3


@pytest.mark.cuda
def test_cuda_multihost_dry_run(cuda):
    """``python -m esr_tpu_torch.parallel.multihost`` on the card over gloo:
    2 processes give the same loss, and the loss and param_l1 of 1 process
    to 1e-5 relative."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "esr_tpu_torch.parallel.multihost", "--backend", "gloo", "--device", "cuda"]
    port = free_port()
    procs = [subprocess.Popen(cmd + ["--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id",
                                     str(i)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=str(REPO)) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    single = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))
    assert all(p.returncode == 0 for p in procs) and single.returncode == 0, [e[-500:] for _, e in outs]
    mh = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    one = json.loads(single.stdout.strip().splitlines()[-1])
    assert mh[0]["loss"] == mh[1]["loss"]
    assert abs(mh[0]["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    assert abs(mh[0]["param_l1"] - one["param_l1"]) <= 1e-5 * abs(one["param_l1"])
