"""The port's host data path and eval ops against the JAX package's (and
against cv2 and PIL for the PNG codec), on the CPU.

The worker loader (``create_worker_loader``, threads) against JAX's train
loader's batches. Tolerances: images, options, uint8 conversions and Z
draws exact; ``imresize_np`` / ``imresize`` and f32 samples 1e-5 (f64 vs
f32 matmul orders); ``calculate_psnr`` / ``calculate_ssim`` 1e-10 (the same float64
math); the device twins of PSNR / SSIM 1e-5 relative (f32).
"""

import io
import json
import os
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from esr_tpu.data import create_dataloader as jcreate_dataloader
from esr_tpu.data import create_dataset as jcreate_dataset
from esr_tpu.data import util as jutil
from esr_tpu.ops import color as jcolor
from esr_tpu.ops import metrics as jmetrics
from esr_tpu.ops.resize import imresize as jimresize
from esr_tpu.ops.resize import imresize_np as jimresize_np
from esr_tpu.options import parse as jparse
from esr_tpu.options import save as jsave
from esr_tpu_torch.data import DataLoader, create_dataset, create_worker_loader, png
from esr_tpu_torch.data import util as putil
from esr_tpu_torch.ops import color as pcolor
from esr_tpu_torch.ops import metrics as pmetrics
from esr_tpu_torch.ops.resize import imresize, imresize_np
from esr_tpu_torch.options import parse, save

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(h, w, c, seed=0, dtype=np.uint8):
    """A smooth image with noise: the rows take every PNG filter when an
    adaptive encoder writes it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.25 * np.sin(xx / 5.0)[..., None] + 0.2 * np.cos(yy / 3.0)[..., None]
    img = np.clip(base + rng.normal(0, 0.05, (h, w, c)), 0, 1)
    top = 255 if dtype == np.uint8 else 65535
    return (img * top).round().astype(dtype)


def _png_with_filters(img: np.ndarray) -> bytes:
    """An 8-bit PNG whose rows cycle through the five filter types, filtered
    by the PNG specification's per-byte formulas (a reference encoder)."""
    h, w, c = img.shape
    raw = bytearray()
    prev = [0] * (w * c)
    for i in range(h):
        row = img[i].reshape(-1).tolist()
        t = i % 5
        out = []
        for k, x in enumerate(row):
            a = row[k - c] if k >= c else 0
            b = prev[k]
            cc = prev[k - c] if k >= c else 0
            if t == 0:
                pred = 0
            elif t == 1:
                pred = a
            elif t == 2:
                pred = b
            elif t == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out.append((x - pred) % 256)
        raw += bytes([t] + out)
        prev = row

    def chunk(ctype, body):
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))

    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _pil_png(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_decodes_every_filter_type(c):
    """Rows of all five filters (None, Sub, Up, Average, Paeth), gray / RGB /
    RGBA: the codec, cv2 and PIL decode the reference file to the image."""
    img = _image(23, 17, c, seed=c)
    data = _png_with_filters(img)
    np.testing.assert_array_equal(png.decode(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))).reshape(img.shape), img)
    cv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED).reshape(img.shape)
    if c >= 3:
        cv = np.concatenate([cv[..., 2::-1], cv[..., 3:]], axis=-1)  # BGR(A) -> RGB(A)
    np.testing.assert_array_equal(cv, img)


@pytest.mark.parametrize("writer,c,dtype", [
    ("cv2", 1, np.uint8), ("cv2", 3, np.uint8), ("cv2", 4, np.uint8), ("cv2", 1, np.uint16),
    ("cv2", 3, np.uint16), ("pil", 1, np.uint8), ("pil", 3, np.uint8), ("pil", 4, np.uint8),
    ("pil_optimize", 3, np.uint8), ("pil", 1, np.uint16),
])
def test_png_decodes_cv2_and_pil_files(writer, c, dtype):
    img = _image(31, 45, c, seed=7, dtype=dtype)
    if writer == "cv2":
        bgr = img if c == 1 else np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
        data = cv2.imencode(".png", bgr[..., 0] if c == 1 else bgr)[1].tobytes()
    else:
        arr = img[..., 0] if c == 1 else img
        data = _pil_png(arr, optimize=writer == "pil_optimize")
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("c", [1, 3])
def test_png_written_by_the_codec_decodes_everywhere(c):
    """cv2 and PIL decode what the codec writes; the round trip is exact, and
    a gray image may also be given as (H, W)."""
    img = _image(29, 40, c, seed=11)
    data = png.encode(img)
    np.testing.assert_array_equal(png.decode(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))).reshape(img.shape), img)
    cv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED).reshape(img.shape)
    np.testing.assert_array_equal(cv if c == 1 else cv[..., ::-1], img)
    if c == 1:
        assert png.encode(img[..., 0]) == data


@pytest.mark.parametrize("what", ["junk", "crc", "palette", "interlaced", "16bit_encode", "truncated",
                                  "huge", "extra_data"])
def test_png_refuses_what_it_cannot_read(what):
    img = _image(8, 8, 3)
    data = png.encode(img)
    if what == "16bit_encode":
        with pytest.raises(ValueError, match="uint8"):
            png.encode(img.astype(np.uint16))
        return
    if what == "junk":
        data = b"not an image at all"
    elif what == "crc":
        data = data[:40] + bytes([data[40] ^ 1]) + data[41:]
    elif what == "palette":
        buf = io.BytesIO()
        Image.fromarray(img).convert("P").save(buf, format="PNG")
        data = buf.getvalue()
    elif what == "interlaced":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        data = buf.getvalue()
        ihdr = bytearray(data[16:29])
        ihdr[12] = 1
        body = bytes(ihdr)
        data = data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]
    elif what == "truncated":
        data = data[: len(data) // 2]
    elif what in ("huge", "extra_data"):
        # a header announcing 2^16 x 2^16 pixels, or more image data than its 8x8
        h = 2**16 if what == "huge" else 8
        body = struct.pack(">IIBBBBB", h, h, 8, 2, 0, 0, 0)
        idat = zlib.compress(bytes(9 * (8 * 3 + 1)))

        def chunk(ctype, b):
            return struct.pack(">I", len(b)) + ctype + b + struct.pack(">I", zlib.crc32(ctype + b))

        data = data[:8] + chunk(b"IHDR", body) + chunk(b"IDAT", idat) + chunk(b"IEND", b"")
    with pytest.raises(ValueError):
        png.decode(data)


@pytest.mark.parametrize("c,dtype", [(3, np.uint8), (1, np.uint8), (4, np.uint8), (3, np.uint16)])
def test_read_img_matches_jax(tmp_path, c, dtype):
    """read_img / read_img_uint8 of a PNG equal the JAX package's (cv2)."""
    img = _image(19, 26, c, seed=3, dtype=dtype)
    path = str(tmp_path / "x.png")
    bgr = img if c == 1 else np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    cv2.imwrite(path, bgr[..., 0] if c == 1 else bgr)
    np.testing.assert_array_equal(putil.read_img(path), jutil.read_img(path))
    np.testing.assert_array_equal(putil.read_img_uint8(path), jutil.read_img_uint8(path))


def test_save_img_and_paths_match_jax(tmp_path):
    """save_img writes what cv2 reads back; get_image_paths, modcrop and
    parse_size equal the JAX package's."""
    img = _image(20, 30, 3, seed=4)
    putil.save_img(img, str(tmp_path / "sub" / "b.png"))
    putil.save_img(img[..., 0], str(tmp_path / "a.png"))
    np.testing.assert_array_equal(jutil.read_img_uint8(str(tmp_path / "sub" / "b.png")), img)
    assert putil.get_image_paths(str(tmp_path)) == jutil.get_image_paths(str(tmp_path))
    np.testing.assert_array_equal(putil.modcrop(img, 4), jutil.modcrop(img, 4))
    for v in (None, 96, [64, 32]):
        assert putil.parse_size(v) == jutil.parse_size(v)


@pytest.mark.parametrize("shape,kw", [((17, 23, 3), {"scale": 0.25}), ((40, 24, 3), {"scale": 0.5}),
                                      ((9, 7), {"scale": 2}), ((2, 12, 16, 3), {"out_shape": (5, 7)})])
def test_imresize_matches_jax(shape, kw):
    img = np.random.default_rng(5).random(shape).astype(np.float32)
    want = np.asarray(jimresize_np(img, **kw))
    np.testing.assert_allclose(imresize_np(img, **kw), want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jimresize(jnp.asarray(img), **kw)), want, atol=1e-5)
    got = imresize(torch.from_numpy(img), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("mode", ["LRHR", "LRHR_with_LR", "LR", "SYNTHETIC"])
def test_eval_samples_match_jax(tmp_path, mode):
    """Eval-phase samples of each dataset mode: HR equal, LR within 1e-5,
    paths equal."""
    rng = np.random.default_rng(6)
    for i, (h, w) in enumerate(((46, 38), (33, 50))):
        putil.save_img((rng.random((h, w, 3)) * 255).astype(np.uint8), str(tmp_path / "hr" / f"{i}.png"))
        putil.save_img((rng.random((h // 4, w // 4, 3)) * 255).astype(np.uint8), str(tmp_path / "lr" / f"{i}.png"))
    d = {"phase": "test", "scale": 4, "mode": "LRHR", "dataroot_HR": str(tmp_path / "hr")}
    if mode == "LRHR_with_LR":
        d["dataroot_LR"] = str(tmp_path / "lr")
    elif mode == "LR":
        d = {"phase": "test", "scale": 4, "mode": "LR", "dataroot_LR": str(tmp_path / "lr")}
    elif mode == "SYNTHETIC":
        d = {"phase": "test", "scale": 4, "mode": "SYNTHETIC", "n_images": 2, "image_size": 42}
    got, want = create_dataset(dict(d)), jcreate_dataset(dict(d))
    assert len(got) == len(want) == 2
    for i in range(2):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in g:
            if k == "HR":
                np.testing.assert_array_equal(g[k], w[k])
            elif k == "LR":
                assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype == np.float32
                np.testing.assert_allclose(g[k], w[k], atol=1e-5)
            else:
                assert g[k] == w[k]


def test_dataloader_batches_in_order_and_surfaces_errors():
    class Boom:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("boom")
            return {"LR": np.full((2, 2, 3), i, np.float32), "LR_path": f"p{i}"}

    loader = DataLoader(Boom(), batch_size=2)
    it = iter(loader)
    first = next(it)
    assert first["LR"].shape == (2, 2, 2, 3) and first["LR_path"] == ["p0", "p1"]
    with pytest.raises(KeyError, match="boom"):
        next(it)


TRAIN_SET = {"mode": "SYNTHETIC", "phase": "train", "HR_size": 16, "n_images": 7, "image_size": 32}


@pytest.mark.parametrize("n_workers", [0, 2])
def test_worker_loader_batch_contract(n_workers):
    """``create_worker_loader`` (the port of ``create_grain_loader``), as
    tests/test_e2e.py holds grain's: one epoch per iteration of full batches
    (7 samples, batch 2: 3 batches, the short one dropped), uint8 HR crops,
    path lists, each sample at most once an epoch, reshuffled each epoch."""
    loader = create_worker_loader(create_dataset(TRAIN_SET), {"batch_size": 2, "n_workers": n_workers})
    orders = []
    for _ in range(2):
        batches = list(loader)
        assert len(batches) == len(loader) == 3
        paths = []
        for batch in batches:
            assert set(batch) == {"LR", "HR", "HR_path", "LR_path"} and batch["LR"] is None
            assert batch["HR"].shape == (2, 16, 16, 3) and batch["HR"].dtype == np.uint8
            assert isinstance(batch["HR_path"], list) and len(batch["HR_path"]) == 2
            paths += batch["HR_path"]
        assert len(set(paths)) == 6
        orders.append(paths)
    assert orders[0] != orders[1]


def test_worker_loader_threads_match_serial_and_jax():
    """``n_workers`` 0 and 2 yield the same batches for the same seed, and so
    does the JAX package's train loader (``create_dataloader``: shuffled by
    seed + epoch), over two epochs; a loader abandoned mid-epoch returns."""
    opt = {"phase": "train", "batch_size": 2, "seed": 3}
    serial = create_worker_loader(create_dataset(TRAIN_SET), dict(opt, n_workers=0))
    threads = create_worker_loader(create_dataset(TRAIN_SET), dict(opt, n_workers=2))
    jax_loader = jcreate_dataloader(jcreate_dataset(dict(TRAIN_SET)), opt)
    for _ in range(2):
        for a, b, j in zip(list(serial), list(threads), list(jax_loader), strict=True):
            assert a["HR_path"] == b["HR_path"] == j["HR_path"]
            assert np.array_equal(a["HR"], b["HR"]) and np.array_equal(a["HR"], np.asarray(j["HR"]))
    it = iter(threads)
    next(it)
    it.close()


def test_worker_loader_threads_share_the_image_cache():
    """16 decode threads (more than the cores) on one SyntheticDataset whose
    LRU holds 2 images, with the interpreter switching threads every
    microsecond: every batch of 3 epochs equals the serial loader's (a cache
    eviction racing a lookup costs a remake, never an error or a wrong
    image)."""
    import sys

    def loader(n_workers):
        ds = create_dataset(dict(TRAIN_SET, n_images=24))
        ds.CACHE_IMAGES = 2
        return create_worker_loader(ds, {"batch_size": 4, "n_workers": n_workers, "seed": 1})

    serial, threads = loader(0), loader(16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            for a, b in zip(list(serial), list(threads), strict=True):
                assert a["HR_path"] == b["HR_path"] and np.array_equal(a["HR"], b["HR"])
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("name", ["test_ESRGAN_CEM.json", "test_RRDB_PSNR.json", "test_explorable.json"])
@pytest.mark.parametrize("is_train", [False, True])
def test_options_parse_matches_jax(name, is_train):
    """The port's copy of each test JSON parses to the JAX package's dict."""
    got = parse(os.path.join(REPO, "esr_tpu_torch", "options", "test", name), is_train=is_train)
    want = jparse(os.path.join(REPO, "esr_tpu", "options", "test", name), is_train=is_train)
    assert got == want
    assert got["missing"] is None and got["datasets"]["test_1"]["phase"] == "test"


def test_options_parse_comments_and_dicts(tmp_path):
    text = '{\n  // a comment\n  "name": "x", "url": "http://a//b", "scale": 2,\n' \
           '  "datasets": {"val_1": {"dataroot_HR": "~/hr"}}\n}'
    p = tmp_path / "o.json"
    p.write_text(text)
    assert parse(str(p), is_train=False) == jparse(str(p), is_train=False)
    opt = {"name": "k", "kernel": np.ones(3), "path": {"root": str(tmp_path)}}
    got, want = parse(opt, is_train=True), jparse(opt, is_train=True)
    dumped = save(got)
    assert json.load(open(dumped)) == json.load(open(jsave(want, str(tmp_path / "jax"))))
    np.testing.assert_array_equal(got.pop("kernel"), want.pop("kernel"))
    assert got == want


def test_color_functions_match_jax():
    rng = np.random.default_rng(8)
    f = rng.random((9, 11, 3)).astype(np.float32)
    u = (f * 255).round().astype(np.uint8)
    for fn in ("rgb2ycbcr", "bgr2ycbcr"):
        for img in (f, u):
            for only_y in (True, False):
                np.testing.assert_array_equal(getattr(pcolor, fn)(img, only_y), getattr(jcolor, fn)(img, only_y))
    for img in (pcolor.rgb2ycbcr(f, False), pcolor.rgb2ycbcr(u, False)):
        np.testing.assert_array_equal(pcolor.ycbcr2rgb(img), jcolor.ycbcr2rgb(img))
    for img in (f, u, u[..., 0]):
        np.testing.assert_array_equal(pcolor.img2tensor(img), jcolor.img2tensor(img))


def test_to_uint8_equals_tensor2img_and_jax():
    """to_uint8 on f32 == tensor2img == to_uint8_jax, bit for bit, including
    values exactly halfway between levels and outside [0, 1]."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-0.2, 1.2, (2, 7, 9, 3)).astype(np.float32)
    x[0, 0, :, 0] = (np.arange(9) + 0.5) / 255.0  # halfway: round half to even
    got = pcolor.to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcolor.to_uint8_jax(jnp.asarray(x))))
    for i in range(2):
        np.testing.assert_array_equal(got[i], pcolor.tensor2img(x[i : i + 1]))
        np.testing.assert_array_equal(got[i], jcolor.tensor2img(x[i : i + 1]))
    np.testing.assert_array_equal(pcolor.to_uint8(torch.from_numpy(x), (-1.0, 2.0)).numpy(),
                                  np.asarray(jcolor.to_uint8_jax(jnp.asarray(x), (-1.0, 2.0))))


@pytest.mark.parametrize("shape", [(24, 20), (24, 20, 3), (24, 20, 1)])
def test_psnr_ssim_match_jax(shape):
    rng = np.random.default_rng(10)
    a = (rng.random(shape) * 255).round()
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255).round()
    assert abs(pmetrics.calculate_psnr(a, b) - jmetrics.calculate_psnr(a, b)) <= 1e-10
    assert abs(pmetrics.calculate_ssim(a, b) - jmetrics.calculate_ssim(a, b)) <= 1e-10
    assert pmetrics.calculate_psnr(a, a) == float("inf")
    np.testing.assert_array_equal(pmetrics.crop_border(a, 4), jmetrics.crop_border(a, 4))


@pytest.mark.parametrize("quantize", [True, False])
def test_device_psnr_ssim_match_jax(quantize):
    rng = np.random.default_rng(11)
    a = rng.random((2, 30, 26, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), -0.1, 1.1).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    for border in (0, 3):
        for p_fn, j_fn in ((pmetrics.psnr_torch, jmetrics.psnr_jax), (pmetrics.ssim_torch, jmetrics.ssim_jax)):
            want = float(j_fn(ja, jb, border=border, quantize=quantize))
            got = p_fn(ta, tb, border=border, quantize=quantize).item()
            assert abs(got - want) <= 1e-5 * abs(want), (p_fn.__name__, border, got, want)
    want = jmetrics.calculate_psnr(pcolor.tensor2img(a[:1]), pcolor.tensor2img(b[:1]))
    assert abs(pmetrics.psnr_torch(ta[:1], tb[:1]).item() - want) <= 1e-4
