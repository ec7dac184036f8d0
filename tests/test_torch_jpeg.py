"""utils/jpeg.py's decode_jpeg against PIL, and glTF JPEG images end to end.

- ``decode_jpeg`` equals PIL's ``Image.open(...).convert("RGBA")`` with
  ``np.array_equal`` on a seeded matrix of files that PIL writes here:
  sizes 1x1 to 333x257 at each chroma subsampling (4:4:4, 4:2:2,
  4:2:0), qualities 5 to 100, 16-bit quantisation tables (SOF1),
  optimised Huffman tables, restart markers by blocks and by rows,
  progressive files at each subsampling, greyscale, ``keep_rgb`` (an
  Adobe RGB file), EXIF and COM segments, and two files whose frame
  header was relabelled to sampling factors PIL does not write (4:4:0,
  whose fancy h1v2 upsampling libjpeg applies, and 4:1:1, which it
  replicates): the same blocks per MCU, so the entropy data still fits.
  A 1024x1024 4:2:0 file prints its decode time.
- Quantisation tables scaled up by hand (samples pushed past [0, 255],
  saturated as PIL's libjpeg-turbo does) and fill bytes before markers
  decode as PIL decodes them.
- Arithmetic coding, 12-bit samples, lossless, four components, a
  progressive file whose scans stop early and coefficients past the
  range where libjpeg-turbo's SIMD IDCT is exact are refused, naming
  the form.
- The committed fixture tests/assets/jpeg.glb (multi.glb's scene with
  its three images as JPEGs: baseline 4:2:0 with restart markers,
  progressive 4:2:2, greyscale) decodes through PIL and decode_jpeg to
  the SHA-256 digests in tests/assets/jpeg_digests.json, and its
  ``cli.main`` frame at 128x72 on the CPU meets the reference's
  ``cli.main`` within the goldens' sRGB RMSE 4e-3.

Rewriting the fixture and its digests (PIL on libjpeg-turbo), and
printing decode_jpeg's seconds per megapixel on this host:

    python tests/test_torch_jpeg.py
    python tests/test_torch_jpeg.py --times
"""

import hashlib
import io
import json
import os
import struct
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # the repo root, when run as a script

from test_torch_bench_hd import smoke_module  # noqa: E402
from transmission_renderer_tpu import cli as jcli  # noqa: E402
from transmission_renderer_tpu_torch import cli  # noqa: E402
from transmission_renderer_tpu_torch.utils.jpeg import decode_jpeg  # noqa: E402
from transmission_renderer_tpu_torch.utils.png import read_png  # noqa: E402

torch.set_num_threads(1)

ASSETS = os.path.join(HERE, "assets")
FIXTURE = os.path.join(ASSETS, "jpeg.glb")
DIGESTS = os.path.join(ASSETS, "jpeg_digests.json")


def textured(w: int, h: int, seed: int, mode: str = "RGB", noise: float = 20.0) -> Image.Image:
    """A seeded image: per-channel sinusoids over a checker, plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ch = 1 if mode == "L" else 3
    phase = rng.uniform(0.0, 6.3, (ch, 2))
    freq = rng.uniform(0.02, 0.2, (ch, 2))
    img = np.stack([128 + 70 * np.sin(x * freq[k, 0] + phase[k, 0])
                    * np.cos(y * freq[k, 1] + phase[k, 1])
                    + 40 * ((x // 16 + y // 16) % 2 - 0.5) for k in range(ch)], -1)
    img = np.clip(img + rng.normal(0.0, noise, img.shape), 0, 255).astype(np.uint8)
    return Image.fromarray(img[..., 0] if ch == 1 else img)


def encode(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def relabel(data: bytes, width: int, height: int, luma_hv: int) -> bytes:
    """``data`` with its SOF0's size and first component's sampling
    factors replaced."""
    i = data.index(b"\xff\xc0")
    return (data[: i + 5] + struct.pack(">HH", height, width) + data[i + 9 : i + 11]
            + bytes([luma_hv]) + data[i + 12 :])


QT16 = [[min(65535, 1 + 37 * i) for i in range(64)], [300 + i for i in range(64)]]
CASES = {
    **{f"{w}x{h}_sub{s}": ((w, h, 1), dict(quality=90, subsampling=s))
       for w, h in ((1, 1), (8, 8), (7, 5), (3, 11), (37, 23), (128, 72), (333, 257))
       for s in (0, 1, 2)},
    **{f"q{q}": ((128, 72, 2), dict(quality=q, subsampling=2)) for q in (5, 50, 100)},
    "qtables_16bit": ((37, 23, 3), dict(qtables=QT16)),
    "qtables_coarse": ((37, 23, 3), dict(qtables=[[255] * 64, [1] * 64], subsampling=1)),
    "optimize": ((128, 72, 4), dict(quality=90, optimize=True, subsampling=2)),
    "restart_blocks": ((128, 72, 5), dict(quality=90, subsampling=2, restart_marker_blocks=3)),
    "restart_rows": ((37, 23, 5), dict(quality=90, subsampling=1, restart_marker_rows=1)),
    **{f"progressive_sub{s}": ((333, 257, 6), dict(quality=75, progressive=True, subsampling=s))
       for s in (0, 1, 2)},
    "progressive_optimize_odd": ((37, 23, 7), dict(quality=30, progressive=True, optimize=True,
                                                   subsampling=2)),
    "progressive_restarts": ((128, 72, 8), dict(quality=90, progressive=True, subsampling=1,
                                                restart_marker_blocks=1)),
    "grey": ((37, 23, 9, "L"), dict(quality=85)),
    "grey_progressive": ((128, 72, 9, "L"), dict(quality=50, progressive=True)),
    "keep_rgb": ((37, 23, 10), dict(quality=80, keep_rgb=True)),
    "keep_rgb_progressive": ((128, 72, 10), dict(quality=80, keep_rgb=True, progressive=True)),
    "exif_comment": ((37, 23, 11), dict(quality=70, comment=b"seeded", exif=b"Exif\x00\x00"
                                        b"MM\x00*\x00\x00\x00\x08\x00\x00\x00\x00\x00\x00")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_pil(case):
    args, kw = CASES[case]
    data = encode(textured(*args), **kw)
    if case == "qtables_16bit":
        assert b"\xff\xc1" in data  # extended sequential, 16-bit tables
    if case.startswith("progressive") or case.endswith("progressive"):
        assert b"\xff\xc2" in data
    if case.startswith("restart"):
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    want = pil_rgba(data)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), int(np.abs(got.astype(int) - want).max())


@pytest.mark.parametrize("form,src,size,hv", [
    # a 4:2:2 file's MCUs (2 luma blocks, Cb, Cr) read as 4:4:0 ones
    ("h1v2", dict(subsampling=1), (21, 45), 0x12),
    # a 4:2:0 file's MCUs (4 luma blocks, Cb, Cr) read as 4:1:1 ones
    ("h4v1", dict(subsampling=2), (77, 13), 0x41),
])
def test_relabelled_sampling_equals_pil(form, src, size, hv):
    data = relabel(encode(textured(37, 23, 12), quality=90, **src), *size, hv)
    want = pil_rgba(data)
    assert want.shape == (size[1], size[0], 4)
    np.testing.assert_array_equal(decode_jpeg(data), want)


def scaled_tables(data: bytes, factor: int) -> bytes:
    """``data`` (8-bit tables) with every quantisation entry multiplied by
    ``factor``, capped at 255: the same coefficients dequantise larger."""
    out, i = bytearray(data), data.index(b"\xff\xdb")
    end = i + 2 + struct.unpack(">H", data[i + 2 : i + 4])[0]
    for k in range(i + 4, end, 65):
        out[k + 1 : k + 65] = bytes(min(255, v * factor) for v in data[k + 1 : k + 65])
    return bytes(out)


def with_fill_bytes(data: bytes) -> bytes:
    """``data`` with an FF fill byte before every DHT and RSTn marker."""
    data = data.replace(b"\xff\xc4", b"\xff\xff\xc4")
    for n in range(8):
        data = data.replace(bytes([0xFF, 0xD0 + n]), bytes([0xFF, 0xFF, 0xD0 + n]))
    return data


@pytest.mark.parametrize("form", ["tables_x2", "fill_bytes"])
def test_altered_files_equal_pil(form):
    """Dequantised coefficients twice the encoder's (q100 tables doubled:
    samples pushed past [0, 255], saturated as PIL's libjpeg-turbo
    does), and fill bytes before markers, in the entropy data too."""
    if form == "tables_x2":
        data = scaled_tables(encode(textured(37, 23, 16), quality=100, subsampling=0), 2)
    else:
        data = with_fill_bytes(encode(textured(128, 72, 17), quality=90, subsampling=2,
                                      restart_marker_blocks=2))
        assert b"\xff\xff\xd0" in data
    np.testing.assert_array_equal(decode_jpeg(data), pil_rgba(data))


def test_decode_1024_prints_its_time():
    data = encode(textured(1024, 1024, 13), quality=90, subsampling=2)
    t0 = time.perf_counter()
    got = decode_jpeg(data)
    sec = time.perf_counter() - t0
    print(f"decode_jpeg 1024x1024 4:2:0 q90 ({len(data)} bytes): {sec:.3f} s on the CPU")
    np.testing.assert_array_equal(got, pil_rgba(data))


def _sof(code: int, precision: int = 8, comps: int = 3) -> bytes:
    body = struct.pack(">BHHB", precision, 16, 16, comps) + b"".join(
        bytes([k + 1, 0x11, 0]) for k in range(comps))
    return (b"\xff\xd8" + bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body
            + b"\xff\xd9")


def _truncated_progressive() -> bytes:
    """A progressive file cut after its first scan (DC only): the AC
    coefficients libjpeg's block smoothing reads stay unknown."""
    data = encode(textured(37, 23, 14), quality=75, progressive=True)
    first = data.index(b"\xff\xda")
    return data[: data.index(b"\xff\xda", first + 2)] + b"\xff\xd9"


REFUSED = {
    "arithmetic": (lambda: _sof(0xC9), "arithmetic-coded"),
    "12-bit": (lambda: _sof(0xC1, precision=12), "12-bit"),
    "lossless": (lambda: _sof(0xC3), "lossless"),
    "cmyk": (lambda: encode(textured(16, 16, 15).convert("CMYK")), "4-component"),
    "progressive_incomplete": (_truncated_progressive, "incomplete"),
    "idct_range": (lambda: scaled_tables(encode(textured(37, 23, 16), quality=100), 60),
                   "16-bit SIMD IDCT"),
}


@pytest.mark.parametrize("form", sorted(REFUSED))
def test_unsupported_forms_are_refused(form):
    make, match = REFUSED[form]
    with pytest.raises(NotImplementedError, match=match):
        decode_jpeg(make(), form)


# ---------------------------------------------------------------------------
# the glTF fixture
# ---------------------------------------------------------------------------

def fixture_images() -> list:
    """(JPEG bytes, form) of jpeg.glb's three images, in multi.glb's
    image order: base colour, metallic-roughness, the leaf's base colour.
    Their sizes keep multi.glb's relation (8, 4 and 8 texels a side), so
    the material taps group into the same meta blocks and the frame
    launches what multi.glb's does."""
    return [
        (encode(textured(512, 512, 21, noise=5.0), quality=90, subsampling=2,
                restart_marker_rows=2), "baseline 4:2:0 q90, restart markers"),
        (encode(textured(256, 256, 22, noise=5.0), quality=85, subsampling=1,
                progressive=True), "progressive 4:2:2 q85"),
        (encode(textured(512, 512, 23, "L", noise=5.0), quality=85), "greyscale q85"),
    ]


def write_fixture() -> None:
    smoke = smoke_module()
    with open(os.path.join(ASSETS, "multi.glb"), "rb") as f:
        multi = f.read()
    images = fixture_images()
    glb = smoke.glb_with_images(multi, [(data, "image/jpeg") for data, _ in images])
    digests = []
    for data, form in images:
        rgba = pil_rgba(data)
        digests.append({"form": form, "shape": list(rgba.shape),
                        "sha256": hashlib.sha256(rgba.tobytes()).hexdigest()})
    with open(FIXTURE, "wb") as f:
        f.write(glb)
    with open(DIGESTS, "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    print(f"wrote {FIXTURE} ({len(glb)} bytes) and {DIGESTS}")


def test_fixture_decodes_to_its_digests():
    """PIL and decode_jpeg both give the committed digests (chip_smoke.py
    phase 14 holds decode_jpeg to them on the card, without PIL)."""
    smoke = smoke_module()
    with open(FIXTURE, "rb") as f:
        images = smoke.glb_images(f.read())
    with open(DIGESTS) as f:
        digests = json.load(f)
    assert len(images) == len(digests) == 3
    assert os.path.getsize(FIXTURE) < 200_000
    for data, want in zip(images, digests):
        assert data[:3] == b"\xff\xd8\xff"
        for rgba in (pil_rgba(data), decode_jpeg(data)):
            assert list(rgba.shape) == want["shape"]
            assert hashlib.sha256(rgba.tobytes()).hexdigest() == want["sha256"]


def test_cli_renders_jpeg_glb_as_the_reference(tmp_path):
    argv = [FIXTURE, "--external-model", "--no-sponza", "--cpu", "--width", "128",
            "--height", "72"]
    assert jcli.main(argv + ["-o", str(tmp_path / "ref.png")]) == 0
    frames = []
    assert cli.main(argv + ["-o", str(tmp_path / "port.png")], frames_out=frames) == 0
    got = read_png(str(tmp_path / "port.png"))[..., :3] / 255.0
    want = read_png(str(tmp_path / "ref.png"))[..., :3] / 255.0
    assert got.shape == (72, 128, 3) and np.isfinite(frames[0]).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse < 4e-3, rmse


TIMED_FORMS = {
    "baseline 4:2:0 q90": dict(quality=90, subsampling=2),
    "baseline 4:2:2 q90": dict(quality=90, subsampling=1),
    "baseline 4:4:4 q90": dict(quality=90, subsampling=0),
    "progressive 4:2:0 q90": dict(quality=90, subsampling=2, progressive=True),
    "greyscale q90": dict(quality=90),
}


def decode_times() -> None:
    """Print decode_jpeg's seconds per megapixel on this host: each
    image of the fixture, then each form of TIMED_FORMS on a seeded
    1024x1024 texture (the best of three decodes)."""
    smoke = smoke_module()
    with open(FIXTURE, "rb") as f:
        fixture = smoke.glb_images(f.read())
    cases = [(f"jpeg.glb image {k}", data) for k, data in enumerate(fixture)]
    for form, kw in TIMED_FORMS.items():
        img = textured(1024, 1024, 31, "L" if form.startswith("grey") else "RGB", noise=5.0)
        cases.append((f"1024x1024 {form}", encode(img, **kw)))
    for label, data in cases:
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            rgba = decode_jpeg(data)
            secs.append(time.perf_counter() - t0)
        mp = rgba.shape[0] * rgba.shape[1] / 1e6
        print(f"{label} ({len(data)} bytes): {min(secs):.3f} s, "
              f"{min(secs) / mp:.3f} s per megapixel")


if __name__ == "__main__":
    if sys.argv[1:] == ["--times"]:
        decode_times()
    else:
        write_fixture()
