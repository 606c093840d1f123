"""Host-side data utilities (port of the eval parts of esr_tpu/data/util.py).

Recursive image path collection, decode to float [0,1] HWC RGB, ``modcrop``
to a multiple of scale. The JAX package decodes with cv2 (BGR, converted to
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
    "decode_image",
    "get_image_paths",
    "is_image_file",
    "modcrop",
    "parse_size",
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
