"""PNG reading and writing with the standard library and NumPy only.

Counterpart of ``transmission_renderer_tpu/utils/image_io.py`` and of the
glTF loader's image decode (``scene/gltf.py::GltfDocument.read_image``),
which go through PIL. The machine with the card has no PIL, so this
module decodes what glTF PNGs and the stored goldens carry, from a path
or from bytes, to exactly what ``PIL.Image.open(...).convert("RGBA")``
gives: colour types 0 (grey), 2 (RGB), 3 (palette, with ``tRNS``), 4
(grey + alpha) and 6 (RGBA); bit depths 8 and 16, and 1, 2 and 4 for
grey and palette; Adam7 interlacing; the five row filters of the PNG
spec (undone over anti-diagonals, so each step is one NumPy operation
over every row). Ancillary chunks (gAMA, sRGB, iCCP, ...) are ignored,
as PIL's conversion ignores them.

How PIL converts to 8 bits, which the decoder follows:

- grey: 1-bit 0/255, 2-bit x 85, 4-bit x 17, 16-bit clipped to 255;
  RGB, grey + alpha and RGBA at 16 bits: the high byte;
- a ``tRNS`` key (grey or RGB) makes alpha 0 where the converted 8-bit
  sample equals the key as PIL reads it: 255 x key at 1 bit, the low
  byte at 16 bits, the raw value otherwise (so a 2- or 4-bit key only
  ever matches a 0 key);
- palette indices past the PLTE read black, past the tRNS opaque.

Anything else (a bit depth the colour type does not allow, an unknown
filter or compression method) raises ValueError naming it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        yield kind, data[pos + 8 : pos + 8 + n]
        pos += 12 + n


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters (PNG spec section 9) of ``height`` rows of
    ``stride`` bytes, each led by its filter byte -> [height, stride]
    uint8. A pixel column depends only on its left, upper and upper-left
    neighbours, so every anti-diagonal of pixel columns is decoded in one
    vectorised step."""
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    kinds = rows[:, 0].astype(np.int32)
    if np.any(kinds > 4):
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    if not np.any(kinds):
        return rows[:, 1:].copy()
    ncol = -(-stride // bpp)
    data = np.zeros((height, ncol * bpp), np.int32)
    data[:, :stride] = rows[:, 1:]
    data = data.reshape(height, ncol, bpp)
    out = np.zeros((height + 1, ncol + 1, bpp), np.int32)  # row/column 0: zeros
    for d in range(height + ncol - 1):
        y = np.arange(max(0, d - ncol + 1), min(height, d + 1))
        x = d - y
        a = out[y + 1, x]  # left
        b = out[y, x + 1]  # up
        c = out[y, x]  # upper left
        f = kinds[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].reshape(height, -1)[:, :stride].astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> [H, W, channels] integer samples."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, -1)[:, : width * channels].reshape(
            h, width, channels).astype(np.int64)
    if depth == 8:
        return rows[:, : width * channels].reshape(h, width, channels).astype(np.int64)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width].reshape(h, width, 1).astype(np.int64)


def _to_rgba(s: np.ndarray, colour: int, depth: int, plte, trns) -> np.ndarray:
    """Integer samples -> [H, W, 4] uint8 as PIL's convert("RGBA")."""
    h, w = s.shape[:2]
    alpha = np.full((h, w), 255, np.int64)
    if colour == 3:
        pal = np.zeros((256, 4), np.int64)
        pal[:, 3] = 255
        if plte is None:
            raise ValueError("palette PNG without a PLTE chunk")
        p = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        pal[: len(p), :3] = p
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:256]
            pal[: len(t), 3] = t
        return pal[s[..., 0]].astype(np.uint8)
    if colour in (0, 4):
        g = s[..., 0]
        if depth == 16:
            g = np.minimum(g, 255) if colour == 0 else g >> 8
        elif depth < 8:
            g = g * (255 // ((1 << depth) - 1))
        if colour == 4:
            alpha = s[..., 1] >> 8 if depth == 16 else s[..., 1]
        elif trns is not None:
            (key,) = struct.unpack(">H", trns[:2])
            key = key * 255 if depth == 1 else (key & 0xFF if depth == 16 else key)
            alpha = np.where(g == key, 0, alpha)
        rgb = np.stack([g, g, g], axis=-1)
    else:
        rgb = s[..., :3] >> 8 if depth == 16 else s[..., :3]
        if colour == 6:
            alpha = s[..., 3] >> 8 if depth == 16 else s[..., 3]
        elif trns is not None:
            key = np.array(struct.unpack(">HHH", trns[:6]), np.int64)
            if depth == 16:
                key = key & 0xFF
            alpha = np.where(np.all(rgb == key, axis=-1), 0, alpha)
    return np.concatenate([rgb, alpha[..., None]], axis=-1).astype(np.uint8)


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """PNG bytes -> [H, W, 4] uint8, as PIL's convert("RGBA") gives it."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header = plte = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: missing IHDR")
    width, height, depth, colour, comp, filt, interlace = header
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f"{name}: unsupported PNG colour type {colour} at bit depth {depth}")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"{name}: unsupported PNG compression {comp}, filter method "
                         f"{filt} or interlace {interlace}")
    ch = _CHANNELS[colour]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    s = np.zeros((height, width, ch), np.int64)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw = max(0, -(-(width - x0) // dx))
        ph = max(0, -(-(height - y0) // dy))
        if pw == 0 or ph == 0:
            continue
        stride = -(-(pw * ch * depth) // 8)
        n = ph * (stride + 1)
        if raw.size < pos + n:
            raise ValueError(f"{name}: image data is too short")
        rows = _unfilter(raw[pos : pos + n], ph, stride, bpp)
        s[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += n
    return _to_rgba(s, colour, depth, plte, trns)


def read_png(src) -> np.ndarray:
    """Decode a PNG from a path or from bytes -> [H, W, 4] uint8 (what
    ``image_io.load_png`` and PIL's convert("RGBA") give)."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return decode_png(bytes(src))
    with open(src, "rb") as f:
        return decode_png(f.read(), str(src))


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
