"""PNG reading and writing with the standard library only.

Counterpart of ``transmission_renderer_tpu/utils/image_io.py`` (which goes
through PIL). The machine with the card has no PIL, and the stored
goldens are 8-bit RGB PNGs, so this module decodes 8-bit greyscale-free
RGB (colour type 2) and RGBA (colour type 6), non-interlaced, with the
five per-row filters of the PNG spec, using ``zlib`` and ``struct``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        yield kind, data[pos + 8 : pos + 8 + n]
        pos += 12 + n


def _unfilter_row(kind: int, raw: bytearray, prev: bytearray, bpp: int):
    """Undo one row's filter in place (PNG spec section 9)."""
    n = len(raw)
    if kind == 0:
        return
    if kind == 1:  # Sub
        for i in range(bpp, n):
            raw[i] = (raw[i] + raw[i - bpp]) & 0xFF
    elif kind == 2:  # Up
        for i in range(n):
            raw[i] = (raw[i] + prev[i]) & 0xFF
    elif kind == 3:  # Average
        for i in range(n):
            left = raw[i - bpp] if i >= bpp else 0
            raw[i] = (raw[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif kind == 4:  # Paeth
        for i in range(n):
            a = raw[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = c
            raw[i] = (raw[i] + pred) & 0xFF
    else:
        raise ValueError(f"unknown PNG filter type {kind}")


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB or RGBA PNG -> [H, W, 4] uint8 (RGB gets an
    opaque alpha channel, like ``image_io.load_png``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: missing IHDR")
    width, height, depth, colour, _comp, _filt, interlace = header
    if depth != 8 or colour not in (2, 6) or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB/RGBA is supported "
            f"(bit depth {depth}, colour type {colour}, interlace {interlace})"
        )
    bpp = 3 if colour == 2 else 4
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: image data has the wrong length")
    out = bytearray(height * stride)
    prev = bytearray(stride)
    for y in range(height):
        row = bytearray(raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)])
        _unfilter_row(raw[y * (stride + 1)], row, prev, bpp)
        out[y * stride : (y + 1) * stride] = row
        prev = row
    img = np.frombuffer(bytes(out), np.uint8).reshape(height, width, bpp)
    if bpp == 3:
        img = np.concatenate(
            [img, np.full((height, width, 1), 255, np.uint8)], axis=-1
        )
    return img


def write_png(path: str, rgb: np.ndarray) -> None:
    """Encode [H, W, 3] (uint8, or float in [0, 1]) as an 8-bit RGB PNG
    with no row filters."""
    img = np.asarray(rgb)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    height, width = img.shape[:2]
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), img[..., :3].reshape(height, -1)],
        axis=1,
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
