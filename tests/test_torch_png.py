"""The port's stdlib PNG codec (utils/png.py) vs the reference's PIL
reader (utils/image_io.py::load_png): identical decodes of the stored
goldens, and a lossless write/read round trip."""

import os

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
