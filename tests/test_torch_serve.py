"""The port's serving path on the CPU: the artifact (``esr_tpu_torch.export``),
its CLI, and the HTTP server (``esr_tpu_torch.scripts.serve``), held against
the live forward and against the JAX package's ``Servable`` on the same
weights.

Tolerances: served PNGs equal the live forward's uint8 exactly (the same
function on the same inputs); the port's ``Servable`` against the JAX one
(a StableHLO artifact lowered for the CPU, f32) within 1e-4.
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from esr_tpu.export import export_servable as jexport_servable
from esr_tpu.export import load_servable as jload_servable
from esr_tpu.models import create_model as jcreate_model
from esr_tpu.models.networks import rrdb_to_torch
from esr_tpu.options import parse as jparse
from esr_tpu_torch.data import png
from esr_tpu_torch.export import export_servable, load_servable
from esr_tpu_torch.models import create_model, make_eval_forward
from esr_tpu_torch.ops.color import tensor2img
from esr_tpu_torch.options import parse
from esr_tpu_torch.scripts import export_model
from esr_tpu_torch.scripts.serve import make_server

torch.set_num_threads(1)

BUCKETS = [(1, 16, 16), (2, 24, 24)]


def _opt(root, pth=None, **extra):
    opt = {
        "name": "serve_test", "model": "sr", "scale": 4, "use_cem": True, "bf16": False,
        "datasets": {"train": {"HR_size": 32}},
        "network_G": {"which_model_G": "RRDB_net", "nf": 16, "nb": 2, "gc": 8, "in_nc": 3,
                      "out_nc": 3, "num_latent_channels": 1, "latent_input": "first_layer"},
        "path": {"root": str(root), "pretrain_model_G": pth},
        "train": {"manual_seed": 0},
    }
    opt.update(extra)
    return opt


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The JAX model and its CPU StableHLO artifact; the port's model on the
    same weights and its artifact."""
    tmp = tmp_path_factory.mktemp("serve")
    jmodel = jcreate_model(jparse(_opt(tmp), is_train=False))
    jart = str(tmp / "jax_artifact")
    jexport_servable(jmodel, BUCKETS, jart, platforms=("cpu",))
    pth = str(tmp / "G.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in rrdb_to_torch(jmodel.state.params).items()}, pth)
    model = create_model(parse(_opt(tmp, pth), is_train=False), device="cpu")
    art = str(tmp / "artifact")
    manifest = export_servable(model, BUCKETS, art)
    return {"tmp": tmp, "jart": jart, "model": model, "art": art, "manifest": manifest, "pth": pth}


@pytest.fixture(scope="module")
def server(artifacts):
    srv = make_server(artifacts["art"], host="127.0.0.1", port=0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _png(arr_u8):
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, headers=None):
    req = urllib.request.Request(f"{url}/sr", data=body, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "image/png"
        return r.read()


def test_manifest(artifacts):
    """The JAX manifest's keys plus the port's; G.pth beside it."""
    m, art = artifacts["manifest"], artifacts["art"]
    with open(os.path.join(artifacts["jart"], "manifest.json")) as f:
        jm = json.load(f)
    assert set(jm) <= set(m)
    assert m["format"] == "esr_tpu_torch" and m["scale"] == 4 and m["nz"] == 1 and m["in_nc"] == 3
    assert m["cem"] and m["cem_scale"] == 4 and m["cem_kernel"] is None and not m["bf16"]
    assert [(e["batch"], e["h"], e["w"]) for e in m["buckets"]] == BUCKETS
    assert m["network_G"]["nb"] == 2
    with open(os.path.join(art, "manifest.json")) as f:
        assert json.load(f) == m
    assert os.path.getsize(os.path.join(art, "G.pth")) > 0


def test_servable_matches_live_forward(artifacts):
    """Servable.sr == make_eval_forward on the edge-padded LR (and Z), batch
    filled with the last image, cropped back: exactly."""
    sv = load_servable(artifacts["art"], device="cpu")
    fwd = make_eval_forward(artifacts["model"].g_module, artifacts["model"].cem)
    rng = np.random.default_rng(0)
    lr = rng.random((1, 14, 11, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (1, 14, 11, 1)).astype(np.float32)
    got = sv.sr(lr, z)
    pad = ((0, 0), (0, 2), (0, 5), (0, 0))
    want = fwd(torch.from_numpy(np.pad(lr, pad, mode="edge")), torch.from_numpy(np.pad(z, pad, mode="edge")))
    np.testing.assert_array_equal(got, want[:, :56, :44].numpy())
    lr2 = rng.random((1, 20, 24, 3)).astype(np.float32)  # fits only the batch-2 bucket
    lr2_p = np.concatenate([np.pad(lr2, ((0, 0), (0, 4), (0, 0), (0, 0)), mode="edge")] * 2)
    want2 = fwd(torch.from_numpy(lr2_p), torch.zeros(2, 24, 24, 1))
    np.testing.assert_array_equal(sv.sr(lr2[0]), want2[:1, :80, :96].numpy())
    with pytest.raises(ValueError, match="no exported bucket"):
        sv.sr(np.zeros((3, 8, 8, 3), np.float32))


def test_servable_matches_jax_servable(artifacts):
    """The port's Servable and the JAX package's, on the same weights and
    requests (a non-square LR with Z; a batch-2 bucket filled from one image;
    zeros Z): within 1e-4."""
    sv = load_servable(artifacts["art"], device="cpu")
    jsv = jload_servable(artifacts["jart"])
    rng = np.random.default_rng(1)
    lr = rng.random((1, 13, 16, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, (1, 13, 16, 1)).astype(np.float32)
    np.testing.assert_allclose(sv.sr(lr, z), np.asarray(jsv.sr(lr, z)), atol=1e-4)
    lr2 = rng.random((22, 19, 3)).astype(np.float32)
    np.testing.assert_allclose(sv.sr(lr2), np.asarray(jsv.sr(lr2)), atol=1e-4)


def test_loaders_refuse_each_others_artifacts(artifacts):
    with pytest.raises(ValueError, match="esr_tpu.export.load_servable"):
        load_servable(artifacts["jart"], device="cpu")
    with pytest.raises(ValueError, match="newer than this loader"):
        jload_servable(artifacts["art"])


def test_export_cli(artifacts, tmp_path):
    """export_model.main writes the artifact the API writes; bad buckets and
    a GPU-less default device raise."""
    opt_path = tmp_path / "opt.json"
    opt_path.write_text(json.dumps(_opt(tmp_path, artifacts["pth"])))
    out = str(tmp_path / "art")
    m = export_model.main(["-opt", str(opt_path), "--shapes", "1x16x16,2x24x24", "--out", out, "--device", "cpu"])
    assert m == artifacts["manifest"]
    rng = np.random.default_rng(2)
    lr = rng.random((10, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(load_servable(out, device="cpu").sr(lr),
                                  load_servable(artifacts["art"], device="cpu").sr(lr))
    with pytest.raises(ValueError, match="BATCHxHxW"):
        export_model.parse_shapes("1x16")


def test_entry_points_default_to_cuda(artifacts, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt_path = tmp_path / "opt.json"
    opt_path.write_text(json.dumps(_opt(tmp_path, artifacts["pth"])))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_model.main(["-opt", str(opt_path), "--out", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_servable(artifacts["art"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_server(artifacts["art"], port=0)


def test_healthz_returns_manifest(server):
    url, srv = server
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == srv.servable.manifest


@pytest.mark.parametrize("channels", [3, 1, 4])
def test_sr_roundtrip(server, channels):
    """A PNG request (RGB, gray or RGBA) answers the PNG of tensor2img of
    Servable.sr on the decoded RGB LR, byte-equal to the codec's encoding."""
    url, srv = server
    rng = np.random.default_rng(3)
    lr_u8 = (rng.random((14, 16, channels)) * 255).astype(np.uint8)
    body = _post(url, _png(lr_u8[..., 0] if channels == 1 else lr_u8))
    sr = png.decode(body)
    assert sr.shape == (56, 64, 3)
    rgb = np.repeat(lr_u8, 3, axis=2) if channels == 1 else lr_u8[..., :3]
    want = tensor2img(srv.servable.sr(rgb.astype(np.float32) / 255.0)[:1])
    np.testing.assert_array_equal(sr, want)
    assert body == png.encode(want)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))), want)


def test_sr_random_z_headers(server):
    url, srv = server
    rng = np.random.default_rng(4)
    lr_u8 = (rng.random((16, 12, 3)) * 255).astype(np.uint8)
    body = _png(lr_u8)
    zeros = _post(url, body)
    z_a = _post(url, body, {"X-Z-Mode": "random", "X-Z-Seed": "7"})
    z_a2 = _post(url, body, {"X-Z-Mode": "random", "X-Z-Seed": "7"})
    z_b = _post(url, body, {"X-Z-Mode": "random", "X-Z-Seed": "8"})
    assert z_a == z_a2 and z_a != zeros and z_a != z_b
    z = np.random.default_rng(7).uniform(-1, 1, (16, 12, 1)).astype(np.float32)
    want = tensor2img(srv.servable.sr(lr_u8.astype(np.float32) / 255.0, z)[:1])
    np.testing.assert_array_equal(png.decode(z_a), want)


def test_errors(server):
    url, _ = server
    for body, what in ((_png(np.zeros((64, 64, 3), np.uint8)), b"no exported bucket"),
                       (b"\x89PNG\r\n\x1a\n junk", b"bad image"), (b"junk", b"bad image")):
        req = urllib.request.Request(f"{url}/sr", data=body, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=120)
        assert e.value.code == 400 and what in e.value.read()
    for path, method in (("/nope", "GET"), ("/nope", "POST")):
        req = urllib.request.Request(f"{url}{path}", data=b"" if method == "POST" else None, method=method)
        with pytest.raises(urllib.error.HTTPError) as e404:
            urllib.request.urlopen(req, timeout=30)
        assert e404.value.code == 404
