"""The port's stdlib PNG codec (utils/png.py) vs the reference's PIL
reader (utils/image_io.py::load_png, and PIL's convert("RGBA") that the
reference's glTF loader uses): identical decodes of the stored goldens
and of every colour type, bit depth and interlace case a glTF PNG may
carry, and a lossless write/read round trip."""

import io
import os
import struct
import zlib

import numpy as np
import pytest

from golden_defs import GOLDEN_DIR
from transmission_renderer_tpu.utils import load_png
from transmission_renderer_tpu_torch.utils.png import read_png, write_png


@pytest.mark.parametrize("name", ["dragon", "test_scene", "attenuation"])
def test_read_png_matches_pil(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape[-1] == 4
    np.testing.assert_array_equal(got, load_png(path))


def test_write_read_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
    path = str(tmp_path / "rt.png")
    write_png(path, img)
    back = read_png(path)
    np.testing.assert_array_equal(back[..., :3], img)
    assert (back[..., 3] == 255).all()
    np.testing.assert_array_equal(load_png(path)[..., :3], img)


def test_rejects_non_png(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        read_png(str(path))


# ---------------------------------------------------------------------------
# every colour type, bit depth and interlace a glTF PNG may carry, encoded
# here (PIL cannot write 16-bit colour, sub-byte grey with tRNS or Adam7)
# and decoded by both PIL and the port
# ---------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack_rows(img, depth):
    rows = []
    for r in img.reshape(img.shape[0], -1):
        if depth == 16:
            rows.append(r.astype(">u2").tobytes())
        elif depth == 8:
            rows.append(r.astype(np.uint8).tobytes())
        else:
            per = 8 // depth
            out = bytearray(-(-len(r) // per))
            for i, v in enumerate(r):
                out[i // per] |= int(v) << (8 - depth * (i % per + 1))
            rows.append(bytes(out))
    return rows


def _filtered(img, depth, rng):
    """Rows of ``img`` (samples [h, w, ch]), each with a random filter."""
    ch = img.shape[2]
    bpp = max(1, ch * depth // 8)
    rows = _pack_rows(img, depth)
    out, prev = b"", bytes(len(rows[0]))
    for r in rows:
        f = int(rng.integers(0, 5))
        res = bytearray(len(r))
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            b, c = prev[i], prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = (0, a, b, (a + b) >> 1,
                    a if pa <= pb and pa <= pc else (b if pb <= pc else c))[f]
            res[i] = (r[i] - pred) & 0xFF
        out += bytes([f]) + bytes(res)
        prev = r
    return out


def _encode(img, colour, depth, interlace, plte=None, trns=None, seed=0):
    rng = np.random.default_rng(seed)
    h, w = img.shape[:2]
    if interlace:
        data = b"".join(_filtered(img[y0::dy, x0::dx], depth, rng)
                        for x0, y0, dx, dy in _ADAM7 if x0 < w and y0 < h)
    else:
        data = _filtered(img, depth, rng)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    png = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if plte is not None:
        png += chunk(b"PLTE", bytes(np.asarray(plte, np.uint8).reshape(-1)))
    if trns is not None:
        png += chunk(b"tRNS", trns)
    return png + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")


def _cases():
    for colour, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                           (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            for interlace in (0, 1):
                for trns in ((False, True) if colour in (0, 2, 3) else (False,)):
                    yield colour, depth, interlace, trns


@pytest.mark.parametrize("colour,depth,interlace,trns", list(_cases()))
def test_decode_matches_pil(colour, depth, interlace, trns):
    """PIL's convert("RGBA") of every case, bit for bit, from bytes."""
    from PIL import Image

    rng = np.random.default_rng(colour * 100 + depth * 4 + interlace * 2 + trns)
    ch = _CHANNELS[colour]
    top = min(1 << depth, 200) if colour == 3 else 1 << depth
    img = rng.integers(0, top, (13, 19, ch))
    plte = rng.integers(0, 256, (200, 3)) if colour == 3 else None
    key = None
    if trns:
        if colour == 3:
            key = bytes(rng.integers(0, 256, 5).astype(np.uint8))
        else:  # the key is a pixel of the image
            key = b"".join(int(x).to_bytes(2, "big") for x in img[0, 0])
    png = _encode(img, colour, depth, interlace, plte, key, seed=depth)
    want = np.asarray(Image.open(io.BytesIO(png)).convert("RGBA"))
    got = read_png(png)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_rejects_what_it_cannot_match():
    """A bit depth the colour type does not allow raises, naming it."""
    png = _encode(np.zeros((2, 2, 3), np.int64), 2, 8, 0)
    bad = png.replace(struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0),
                      struct.pack(">IIBBBBB", 2, 2, 4, 2, 0, 0, 0))
    with pytest.raises(ValueError, match="colour type 2 at bit depth 4"):
        read_png(bad)
