"""The inference entry points at the flagship width on the card, on the
weights of ``define_G(seed=0)`` loaded back from a ``.pth``.

The eval CLI (``esr_tpu_torch.test.main``): a SYNTHETIC set (4 images, HR
512) and a folder of PNGs written by the port's codec (a DIV2K-sized HR
2040 x 1356, LR 510 x 339, and a ragged HR 406 x 301: modcrop, then
``eval_pad_bucket`` 32), two Z draws; serially, with ``eval_batch`` 4, and
the DIV2K-sized image with ``self_ensemble``: launches per forward, the CEM
residual of every draw, batched == serial, the saved PNGs == the SR uint8,
one forward graph per padded shape, the DIV2K-sized image's PSNR against
the f32 plain path beside the bf16 plain path's.

Serving: export buckets 1x64x64, 1x128x128, 1x96x96, the HTTP server in a
thread (``make_server``'s warm-up captures one forward graph per bucket),
GET /healthz, POST /sr (zeros Z, a seeded random Z twice and another seed,
a junk body, an image too large): each answer equal to the live
Servable's, to its graph and to the eager forward on the padded LR cropped
back. Their times are the benchmark's cells'.
"""

import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from esr_tpu_torch import test as eval_cli
from esr_tpu_torch.data import create_dataset, png
from esr_tpu_torch.data.lrhr_dataset import SyntheticDataset
from esr_tpu_torch.data.util import read_img_uint8, save_img
from esr_tpu_torch.models import create_model, make_eval_forward
from esr_tpu_torch.ops import tensor2img
from esr_tpu_torch.options import parse
from torch_card import (CEM_TOL, METRIC_TOL, NZ, PSNR_MARGIN_DB, SCALE, counted, flagship_options, g0_pth,  # noqa: F401
                        max_err, per_forward, plain_path, psnr, run_cli)

DRAWS, IMAGES = 3, 6  # num_random_Z 2 and the zero-Z draw; 4 synthetic images and 2 PNGs


def _u8(a):
    return (a * 255.0).round().astype(np.uint8)


@pytest.fixture(scope="module")
def evals(g0_pth, tmp_path_factory):
    """The eval CLI's runs: serial (saving its images), ``eval_batch`` 4, and
    ``self_ensemble`` on the DIV2K-sized image; (metrics, launches) each."""
    tmp = tmp_path_factory.mktemp("eval")
    hr_dir, big_dir = tmp / "hr", tmp / "hr_div2k"
    big = _u8(SyntheticDataset({"phase": "test", "image_size": 2040})._make_image(5)[:, :1356])
    save_img(big, str(hr_dir / "div2k.png"))
    save_img(big, str(big_dir / "div2k.png"))
    save_img(_u8(SyntheticDataset({"phase": "test", "image_size": 406})._make_image(6)[:, :301]),
             str(hr_dir / "ragged.png"))
    datasets = {"test_1": {"name": "synthetic", "mode": "SYNTHETIC", "n_images": 4, "image_size": 512},
                "test_2": {"name": "folder", "mode": "LRHR", "dataroot_HR": str(hr_dir)}}
    common = {"num_random_Z": 2, "eval_pad_bucket": 32}
    serial_opt = flagship_options(tmp, g0_pth, "eval_serial", datasets, **common)
    return {"tmp": tmp, "serial_opt": serial_opt,
            "serial": run_cli(tmp, serial_opt, "--save_images"),
            "batched": run_cli(tmp, flagship_options(tmp, g0_pth, "eval_batched", datasets, eval_batch=4, **common)),
            "self_ensemble": run_cli(tmp, flagship_options(
                tmp, g0_pth, "eval_self_ensemble", {"test_1": {"name": "div2k", "mode": "LRHR",
                                                               "dataroot_HR": str(big_dir)}},
                self_ensemble=True, num_random_Z=0))}


@pytest.mark.cuda
@pytest.mark.parametrize("run,forwards", [("serial", IMAGES * DRAWS), ("batched", 3 * DRAWS), ("self_ensemble", 2)])
def test_cuda_eval_cli_launches(evals, run, forwards):
    """69 / 4 / 2 launches a generator call: serially one a draw of each
    image; batched, the synthetic set in one batch of 4 and the folder's two
    shapes one each; the self-ensemble's 2 calls (its 8 transforms in 2
    batches) on the DIV2K-sized image."""
    assert evals[run][1] == per_forward(forwards)


@pytest.mark.cuda
def test_cuda_eval_cli_batched_equals_serial(evals):
    """The same metrics serial and batched: the CEM residual of every draw
    within CEM_TOL in both, the rest within ``METRIC_TOL`` (else 1e-3
    relative); the self-ensemble's CEM residual within CEM_TOL."""
    serial, batched = evals["serial"][0], evals["batched"][0]
    for name, s in serial.items():
        b = batched[name]
        assert sorted(s) == sorted(b), name
        for k, v in s.items():
            if k == "cem_residual":
                assert v <= CEM_TOL and b[k] <= CEM_TOL, (name, v, b[k])
            else:
                assert abs(b.get(k, math.inf) - v) <= METRIC_TOL.get(k, 1e-3 * abs(v)), (name, k, v, b.get(k))
    assert evals["self_ensemble"][0]["div2k"]["cem_residual"] <= CEM_TOL


@pytest.fixture(scope="module")
def eval_model(evals):
    """The model the serial CLI run builds, and its folder set."""
    opt = parse(evals["serial_opt"], is_train=False)
    return create_model(opt), create_dataset(opt["datasets"]["test_2"])


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_eval_cli_saved_pngs_are_the_sr(evals, eval_model):
    """Each saved PNG of the folder's images (the zero-Z draw and the second
    random one) decodes to the SR uint8 of the model the CLI builds, on the
    LR padded to its bucket; one forward graph per padded shape."""
    model, folder = eval_model
    out_dir = evals["tmp"] / "results" / "eval_serial" / "folder"
    for idx, name in enumerate(("div2k", "ragged")):
        lr_p, orig = eval_cli._pad_to_bucket(folder[idx]["LR"], 32)
        for zi in (0, 2):  # the first call of the padded shape captures its graph, the second replays it
            model.feed_data({"LR": lr_p})
            model.test(z=eval_cli._eval_z_draw(idx, zi - 1, lr_p.shape[:2], NZ) if zi else None)
            want = eval_cli._sr_image(model.get_visuals_uint8()["SR"], orig, SCALE)
            saved = read_img_uint8(str(out_dir / f"{name}{'_z%d' % zi if zi else ''}.png"))
            assert saved.shape == want.shape and bool((saved == want).all()), (name, zi)
    assert len(model._forward.graphs.steps) == 2


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_eval_div2k_sized_forward(eval_model):
    """The DIV2K-sized LR (510 x 339, an odd width) unpadded through the
    model's forward: 69 / 4 / 2 launches, CEM residual within CEM_TOL, PSNR
    against the f32 plain path at most PSNR_MARGIN_DB below the bf16 plain
    path's."""
    model, folder = eval_model
    g, cem, fwd = model.g_module, model.cem, model._forward
    lr = torch.from_numpy(folder[0]["LR"])[None].cuda()
    z = torch.from_numpy(eval_cli._eval_z_draw(0, 0, lr.shape[1:3], NZ))[None].cuda()
    out, launches = counted(lambda: fwd(lr, z))
    assert launches == per_forward(1)
    assert max_err(cem.downsample(out), lr) <= CEM_TOL
    ref32 = plain_path(g, cem, torch.float32)(lr, z)
    pk, pp = psnr(out, ref32), psnr(plain_path(g, cem, torch.bfloat16)(lr, z), ref32)
    assert pk >= pp - PSNR_MARGIN_DB, (pk, pp)


# -- serving -----------------------------------------------------------------------

BUCKETS = [(1, 64, 64), (1, 128, 128), (1, 96, 96)]


def post_sr(url: str, body: bytes, headers: dict | None = None) -> tuple[int, bytes]:
    req = urllib.request.Request(f"{url}/sr", data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def served(g0_pth, tmp_path_factory):
    """The flagship exported at ``BUCKETS`` and served over HTTP from a
    thread: the server, its thread, its URL, the manifest and the model."""
    from esr_tpu_torch.export import export_servable
    from esr_tpu_torch.scripts.serve import make_server

    tmp = tmp_path_factory.mktemp("serve")
    model = create_model(parse(flagship_options(tmp, g0_pth, "serve", {}), is_train=False))
    manifest = export_servable(model, BUCKETS, str(tmp / "artifact"))
    server = make_server(str(tmp / "artifact"), "127.0.0.1", 0)  # loads, builds layouts, one forward per bucket
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    s = {"server": server, "thread": thread, "url": f"http://127.0.0.1:{server.server_address[1]}",
         "manifest": manifest, "model": model}
    yield s
    if thread.is_alive():
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


@pytest.mark.cuda
def test_cuda_serve_warm_up_and_healthz(served):
    """make_server's warm-up captured one forward graph per bucket, and GET
    /healthz returns the manifest."""
    steps = served["server"].servable.forward.graphs.steps
    assert len(steps) == len(BUCKETS) and all(st.graph is not None for st in steps)
    with urllib.request.urlopen(f"{served['url']}/healthz", timeout=60) as r:
        assert r.status == 200 and json.loads(r.read()) == served["manifest"]


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_serve_answers_requests(served):
    """POST /sr with LR 64x64 (zeros Z) and 96x80 (random Z, seed 1 twice
    and seed 2): HTTP 200, 69 / 4 / 2 launches a request, the answer equal
    to the live Servable's and to the eager forward on the padded LR cropped
    back, the Servable's graph equal to the eager forward bit for bit, CEM
    residual within CEM_TOL; seed 1 twice gives the same bytes, seed 2 and
    zeros Z others."""
    model, sv = served["model"], served["server"].servable
    live = make_eval_forward(model.g_module, model.cem, graphs=False)
    rng = np.random.default_rng(2)
    lr64 = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    lr96 = (rng.random((96, 80, 3)) * 255).astype(np.uint8)
    answers = []
    for img, seed in ((lr64, None), (lr96, 1), (lr96, 1), (lr96, 2)):
        headers = {} if seed is None else {"X-Z-Mode": "random", "X-Z-Seed": str(seed)}
        request = png.encode(img)
        (code, body), launches = counted(lambda: post_sr(served["url"], request, headers))  # noqa: B023
        assert code == 200 and launches == per_forward(1), (seed, code, launches)
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
        assert sr.shape == (SCALE * h, SCALE * w, 3), seed
        assert bool((sr == tensor2img(sv.sr(lr, z)[:1])).all()), seed
        assert bool((sr == tensor2img(out[:, : SCALE * h, : SCALE * w])).all()), seed
        assert torch.equal(sv.forward(lr_p, z_p), out), seed
        assert max_err(model.cem.downsample(out), lr_p) <= CEM_TOL, seed
        answers.append(body)
    assert answers[1] == answers[2] and answers[1] != answers[3] and answers[0] != answers[1]


@pytest.mark.cuda
def test_cuda_serve_refuses_junk_and_unbucketed(served):
    """A junk body and an LR of 200 x 200, which no exported bucket holds:
    HTTP 400 each."""
    code, _ = post_sr(served["url"], b"junk, not an image")
    assert code == 400
    code, msg = post_sr(served["url"], png.encode((np.random.default_rng(2).random((200, 200, 3)) * 255)
                                                  .astype(np.uint8)))
    assert code == 400 and b"no exported bucket" in msg


@pytest.mark.cuda
def test_cuda_serve_thread_stops(served):
    served["server"].shutdown()
    served["server"].server_close()
    served["thread"].join(timeout=60)
    assert not served["thread"].is_alive()
