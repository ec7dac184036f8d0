"""Shared by the tests of the rasters' pixel box: the widened screen box
computed in numpy, and the sliver of card_defs.py (SLIVER, SLIVER_PIXEL),
whose float32 edge functions read "inside" at a pixel past that box."""

import numpy as np

from card_defs import SLIVER, SLIVER_PIXEL  # noqa: F401


def pixel_box(clip, tris, width, height) -> np.ndarray:
    """[T, 4] float32 (x0, y0, x1, y1): the vertices' screen box widened
    by one pixel, floor(min) - 1 to floor(max) + 1, clamped to the screen
    (NaN reading 0); the whole screen for a vertex behind the eye."""
    v = np.asarray(clip, np.float32)[np.asarray(tris)]
    x, y, w = v[..., 0], v[..., 1], v[..., 3]
    safe = np.maximum(w, np.float32(1e-30))
    sx = (x / safe + np.float32(1.0)) * np.float32(0.5 * width)
    sy = (y / safe + np.float32(1.0)) * np.float32(0.5 * height)
    behind = (w <= np.float32(1e-6)).any(-1)

    def bound(a, n):
        return np.clip(np.nan_to_num(a, nan=0.0), 0, n - 1)

    with np.errstate(invalid="ignore"):
        box = [np.where(behind, 0, bound(np.floor(sx.min(-1)) - 1, width)),
               np.where(behind, 0, bound(np.floor(sy.min(-1)) - 1, height)),
               np.where(behind, width - 1, bound(np.floor(sx.max(-1)) + 1, width)),
               np.where(behind, height - 1, bound(np.floor(sy.max(-1)) + 1, height))]
    return np.stack(box, -1).astype(np.float32)
