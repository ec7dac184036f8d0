"""Block-sparse pixel worklists of 128-pixel blocks.

Counterpart of ``transmission_renderer_tpu/render/sparse.py`` (BLOCK,
BlockWork, num_blocks, pixel_coords, block_gather, block_scatter): a
static-capacity list of flat 128-px block ids over an [H, W] frame;
empty slots hold ``n_blocks``, a zero pad row that gathers read and
scatters drop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 128


class BlockWork(NamedTuple):
    block_ids: torch.Tensor  # [cap_b] int32; empty slots hold n_blocks
    count: torch.Tensor  # [] int32 active blocks (may exceed cap_b)
    n_blocks: int
    cap_b: int
    shape: tuple  # (H, W)

    @property
    def num_pixels(self) -> int:
        return self.cap_b * BLOCK


def num_blocks(h: int, w: int) -> int:
    return (h * w + BLOCK - 1) // BLOCK


def _padded_rows(wk: BlockWork, img: torch.Tensor) -> torch.Tensor:
    """[H, W(,C)] -> [n_blocks + 1, BLOCK(, C)] with a zero pad row."""
    h, w = wk.shape
    chans = img.shape[2:]
    flat = img.reshape((h * w,) + chans)
    pad = (wk.n_blocks + 1) * BLOCK - h * w
    flat = torch.cat([flat, flat.new_zeros((pad,) + chans)])
    return flat.reshape((wk.n_blocks + 1, BLOCK) + chans)


def block_gather(wk: BlockWork, img: torch.Tensor) -> torch.Tensor:
    """[H, W(,C)] -> [cap_b * 128(, C)]; empty slots read zeros."""
    rows = _padded_rows(wk, img)[wk.block_ids.long()]
    return rows.reshape((wk.num_pixels,) + img.shape[2:])


def block_scatter(wk: BlockWork, vals: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Scatter [cap_b * 128(, C)] back over an [H, W(,C)] image; empty
    slots land on the pad row and are dropped."""
    h, w = wk.shape
    chans = out.shape[2:]
    rows = _padded_rows(wk, out)
    rows[wk.block_ids.long()] = vals.reshape((wk.cap_b, BLOCK) + chans)
    return rows.reshape((-1,) + chans)[: h * w].reshape((h, w) + chans)


def pixel_coords(wk: BlockWork) -> tuple[torch.Tensor, torch.Tensor]:
    """Framebuffer (x, y) of each worklist pixel (empty slots clamp)."""
    w = wk.shape[1]
    lane = torch.arange(BLOCK, dtype=torch.int32, device=wk.block_ids.device)
    flat = (wk.block_ids[:, None] * BLOCK + lane[None, :]).reshape(-1)
    flat = torch.clamp(flat, max=wk.shape[0] * wk.shape[1] - 1)
    return flat % w, flat // w
