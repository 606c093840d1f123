"""A small PNG codec on stdlib ``zlib`` and numpy.

The JAX package decodes with cv2 and its server with PIL; the port needs
neither, so that it runs where only PyTorch and numpy are installed. Host
code, not a device path.

- ``decode`` reads non-interlaced PNGs of color type 0 (gray), 2 (RGB) and
  6 (RGBA) at 8 or 16 bits, with any of the five row filters (None, Sub,
  Up, Average, Paeth), checking every chunk's CRC. It returns the samples as
  stored: (H, W, C) uint8 or uint16, C in {1, 3, 4}. Any other PNG raises a
  ``ValueError`` naming what it holds.
- ``encode`` writes 8-bit gray or RGB with the Up filter on every row.

Average and Paeth rows depend on the pixel to the left, so a row cannot be
undone as one vector; ``_unfilter`` walks the image by anti-diagonals
(pixel (i, j) needs (i, j-1), (i-1, j) and (i-1, j-1), all on earlier
diagonals), each diagonal one vector over its rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode", "encode", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples per pixel
_COLOR_NAMES = {3: "palette", 4: "gray + alpha"}
MAX_PIXELS = 2**28  # refuse larger images before inflating them (outside input)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the row filters: ftype (H,) in 0..4, filt (H, W, bpp) uint8 ->
    the reconstructed bytes (H, W, bpp)."""
    h, w, bpp = filt.shape
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up only: each row is one vector (uint8 wraps mod 256)
        out = np.empty_like(filt)
        prev = np.zeros((w, bpp), np.uint8)
        for i in range(h):
            t = ftype[i]
            prev = out[i] = filt[i] + prev if t == 2 else np.cumsum(filt[i], 0, np.uint8) if t == 1 else filt[i]
        return out
    # the anti-diagonal walk over a padded, flattened reconstruction:
    # recon[(i + 1) * (w + 1) + j + 1] is pixel (i, j); row 0 and column 0
    # are the zeros the filters take outside the image
    w1 = w + 1
    recon = np.zeros(((h + 1) * w1, bpp), np.int16)
    f16 = filt.reshape(h * w, bpp).astype(np.int16)
    t_rows = ftype.astype(np.intp)[:, None]
    rows = np.arange(h)
    for d in range(h + w - 1):
        i = rows[max(0, d - w + 1) : min(h, d + 1)]
        out = (i + 1) * w1 + (d + 1 - i)
        a, b, c = recon[out - 1], recon[out - w1], recon[out - w1 - 1]  # left, up, up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(t_rows[i], (0, a, b, (a + b) >> 1, paeth))
        recon[out] = (f16[i * w + (d - i)] + pred) & 255
    return recon.reshape(h + 1, w1, bpp)[1:, 1:].astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 or uint16 samples (see module docstring)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR chunk of {len(body)} bytes, 13 expected")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype not in (b"IEND", b"PLTE") and not ctype[0] & 0x20:
            raise ValueError(f"unknown critical PNG chunk {ctype!r}")
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG color type {color} ({_COLOR_NAMES.get(color, 'unknown')}) is not "
                         "supported: gray, RGB and RGBA only")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported: 8 or 16 only")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if compression or filter_method:
        raise ValueError(f"unknown PNG compression {compression} / filter method {filter_method}")
    if w * h > MAX_PIXELS:
        raise ValueError(f"PNG of {w}x{h} pixels is larger than the {MAX_PIXELS} this codec reads")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    expected = h * (w * bpp + 1)
    try:  # inflate no more than the header announces (a zlib bomb stops there)
        raw = zlib.decompressobj().decompress(b"".join(idat), expected + 1)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    if len(raw) != expected:
        raise ValueError(f"PNG image data has {len(raw)}{'+' if len(raw) > expected else ''} bytes, "
                         f"{expected} expected")
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * bpp + 1)
    ftype = rows[:, 0]
    if ftype.size and ftype.max() > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    pix = _unfilter(ftype, rows[:, 1:].reshape(h, w, bpp))
    if depth == 16:
        return pix.reshape(h, w * ch, 2).view(">u2").astype(np.uint16).reshape(h, w, ch)
    return pix.reshape(h, w, ch)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode(img: np.ndarray) -> bytes:
    """(H, W), (H, W, 1) or (H, W, 3) uint8 -> PNG bytes (8-bit gray or RGB)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"encode takes gray or RGB images, got shape {img.shape}")
    h, w, ch = img.shape
    up = img.copy()
    up[1:] -= img[:-1]  # Up filter, modulo 256
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up.reshape(h, w * ch)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
