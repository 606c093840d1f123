"""Host-side data utilities (port of esr_tpu/data/util.py).

Recursive image path collection, decode to float [0,1] HWC RGB, ``modcrop``
to a multiple of scale, and the training crops and flips (``random_crop_pair``,
``augment``: numpy draws from the caller's ``Generator``, so the crops are
the JAX package's, bit for bit). The JAX package decodes with cv2 (BGR, converted to
RGB there); the port decodes PNG with its own codec (``data/png.py``), so it
needs neither cv2 nor PIL, and any other format through PIL where PIL is
installed. The images are the same: gray stays one channel, an alpha channel
is dropped, 16-bit samples scale by 1/65535.
"""

from __future__ import annotations

import io
import os

import numpy as np

from esr_tpu_torch.data import png

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".tif", ".tiff", ".webp")

__all__ = [
    "augment",
    "decode_image",
    "get_image_paths",
    "is_image_file",
    "modcrop",
    "parse_size",
    "random_crop_pair",
    "read_img",
    "read_img_uint8",
    "save_img",
]


def is_image_file(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def get_image_paths(dataroot: str) -> list[str]:
    if dataroot is None:
        return []
    if not os.path.isdir(dataroot):
        raise FileNotFoundError(f"{dataroot} is not a directory")
    paths = []
    for root, _, files in sorted(os.walk(dataroot)):
        paths.extend(os.path.join(root, f) for f in sorted(files) if is_image_file(f))
    if not paths:
        raise FileNotFoundError(f"no images found under {dataroot}")
    return paths


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decode_image(data: bytes, what: str = "image") -> np.ndarray:
    """Encoded image bytes -> HWC RGB (or gray, C=1) in the file's own dtype
    (uint8 / uint16), alpha dropped. PNG through the port's codec; any other
    format through PIL, and without PIL a ``ValueError`` naming the format."""
    if data.startswith(b"\x89PNG"):
        img = png.decode(data)
    else:
        pil = _pil()
        if pil is None:
            kind = {b"\xff\xd8": "JPEG", b"BM": "BMP", b"II": "TIFF", b"MM": "TIFF"}.get(data[:2])
            kind = kind or ("WebP" if data[8:12] == b"WEBP" else "non-PNG")
            raise ValueError(f"{what}: {kind} needs PIL, which is not installed; "
                             "the port decodes PNG on its own — convert the image to PNG")
        try:
            im = pil.open(io.BytesIO(data))
            im.load()
        except Exception as e:  # noqa: BLE001 — PIL raises several types on junk
            raise ValueError(f"{what}: cannot decode ({e})") from e
        if im.mode in ("I;16", "I;16B", "I;16L"):
            img = np.asarray(im, np.uint16)
        else:
            img = np.asarray(im.convert("L" if im.mode in ("1", "L", "LA") else "RGB"))
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img


def _decode(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def _to_float(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def read_img(path: str) -> np.ndarray:
    """Decode an image file to HWC float32 RGB in [0,1]."""
    return np.ascontiguousarray(_to_float(_decode(path)))


def read_img_uint8(path: str) -> np.ndarray:
    """Decode to HWC RGB keeping uint8 when the file is 8-bit; other
    sources come back as float32 [0,1]."""
    img = _decode(path)
    return np.ascontiguousarray(img if img.dtype == np.uint8 else _to_float(img))


def save_img(img: np.ndarray, path: str) -> None:
    """Save an HWC uint8 RGB (or HW gray) image: PNG through the port's
    codec, any other extension through PIL."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.lower().endswith(".png"):
        png.write_png(path, img)
        return
    pil = _pil()
    if pil is None:
        raise ValueError(f"{path}: writing {os.path.splitext(path)[1]} needs PIL, which is not "
                         "installed; the port writes PNG on its own")
    pil.fromarray(np.asarray(img)).save(path)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop so H and W are multiples of scale (the eval convention)."""
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...]


def parse_size(v, default: int = 128) -> tuple[int, int]:
    """``HR_size`` as (H, W): an int means square; a 2-sequence [H, W] means a
    rectangle."""
    if v is None:
        return (default, default)
    if isinstance(v, (list, tuple)):
        if len(v) != 2:
            raise ValueError(f"HR_size must be an int or [H, W], got {v!r}")
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def augment(imgs, hflip: bool = True, rot: bool = True, rng=None):
    """Joint random flip / rot90 of a list of HWC images (the host path)."""
    rng = rng or np.random.default_rng()
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def one(img):
        if do_h:
            img = img[:, ::-1, :]
        if do_v:
            img = img[::-1, :, :]
        if do_r:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [one(i) for i in imgs]


def random_crop_pair(hr: np.ndarray, lr: np.ndarray | None, hr_size, scale: int, rng):
    """Aligned random crop: HR to ``hr_size`` (int -> square, or (H, W)), LR
    to hr_size / scale; an image smaller than the crop is reflect-padded."""
    size_h, size_w = parse_size(hr_size)
    h, w = hr.shape[:2]
    if h < size_h or w < size_w:
        ph, pw = max(0, size_h - h), max(0, size_w - w)
        hr = np.pad(hr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        if lr is not None:
            lr = np.pad(lr, ((0, ph // scale), (0, pw // scale), (0, 0)), mode="reflect")
        h, w = hr.shape[:2]
    if lr is not None:
        lr_h, lr_w = size_h // scale, size_w // scale
        ly = int(rng.integers(0, h // scale - lr_h + 1))
        lx = int(rng.integers(0, w // scale - lr_w + 1))
        y, x = ly * scale, lx * scale
        return hr[y : y + size_h, x : x + size_w], lr[ly : ly + lr_h, lx : lx + lr_w]
    y = int(rng.integers(0, h - size_h + 1))
    x = int(rng.integers(0, w - size_w + 1))
    return hr[y : y + size_h, x : x + size_w], None
