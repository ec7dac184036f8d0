"""The clip peel's re-race bookkeeping (render/frame.py: _clip_worklist,
_clip_merge; csrc/clip_peel.cu on the card) in its plain form, against
the per-channel dict round it replaces.

A synthetic peel state (random winners, a random ok state, tiles with no
winner, int channels holding NaN and denormal bit patterns) goes through
one round both ways: the stacked state's worklist and merge, and the
former code, which kept each channel as an [n_tiles + 1, 8, 128] tensor
(row n_tiles the empty slots' write target) and updated it by gather,
where and index-put. Both give the same slot ids, raced tile ids, demand,
kernel-1 inputs and state bit for bit, and the merged winner lands in the
raced channels of every live slot, as the alpha test reads them. The card
kernels are held to these plain versions in tests/test_torch_cuda.py."""

import pytest
import torch

from transmission_renderer_tpu_torch.ops.raster_gbuf import INT_CHANNELS, active_channels
from transmission_renderer_tpu_torch.render.frame import (
    CLIP_MERGE_KERNEL,
    CLIP_WORKLIST_KERNEL,
    PEEL_DEPTH,
    _clip_merge,
    _clip_worklist,
    _peel_channels,
)

torch.set_num_threads(1)

N_TILES = 24
# bit patterns an int channel carries through the state as float32 words:
# -1 (no winner) and quiet / signalling NaNs, +inf, -0, denormals
PATTERNS = torch.tensor([-1, 0x7FC00001, 0x7F800001, 0x7F800000, -(2**31), 1, 7, 12345],
                        dtype=torch.int32)


def _channels(gen, k: int, names) -> dict:
    """Random kernel-1-like channels [k, 8, 128]: winners (tri >= 0) on
    about half the pixels, every tile from a third on with none in the
    first two tiles, int channels mixing PATTERNS into their ids."""
    shape = (k, 8, 128)
    ch = {}
    for n in names:
        if n in INT_CHANNELS:
            a = torch.randint(0, 40, shape, generator=gen, dtype=torch.int32)
            odd = torch.rand(shape, generator=gen) < 0.3
            pick = torch.randint(0, len(PATTERNS), shape, generator=gen)
            ch[n] = torch.where(odd, PATTERNS[pick], a)
        else:
            ch[n] = torch.randn(shape, generator=gen)
    nowin = torch.rand(shape, generator=gen) < 0.5
    nowin[:2] = True
    ch["tri"] = torch.where(nowin, -1, ch["tri"])
    ch["depth"] = torch.rand(shape, generator=gen)
    return ch


def _dict_round(state: dict, ok_p, init_tiles, pad_tile, t0: int, cap: int, raced: dict):
    """The former round: the per-channel dict state (with its pad row),
    updated in place -> (ids, raced tile ids, demand, seed depths, peel
    bounds, the merged channels of every slot)."""
    n_tiles = init_tiles.shape[0]
    local_ids = torch.arange(n_tiles, dtype=torch.int32)
    failed = (state["tri"][:n_tiles] >= 0) & ~ok_p[:n_tiles]
    ft = failed.reshape(n_tiles, -1).any(dim=1)
    demand = ft.to(torch.int32).sum()
    pos = torch.cumsum(ft.to(torch.int32), 0) - 1
    tgt = torch.where(ft & (pos < cap), pos, cap).long()
    ids = torch.full((cap + 1,), n_tiles, dtype=torch.int32)
    ids[tgt] = local_ids
    ids = ids[:cap]
    safe_ids = torch.where(ids >= n_tiles, pad_tile, ids)
    safe = safe_ids.long()
    prev = {n: a[safe] for n, a in state.items()}
    failed_sel = failed[safe]
    maxd = torch.where(failed_sel, prev["depth"], torch.inf).contiguous()
    sub = {n: torch.where(failed_sel, raced[n], prev[n]) for n in state}
    for n, a in state.items():
        a[ids.long()] = sub[n]
    return ids, safe_ids + t0, demand, init_tiles[safe], maxd, sub


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# (cap, t0): demand above the cap (the overflow keeps the lowest tiles),
# a band's offset, a cap with empty slots, every tile (the cells' 1.0)
CASES = {"overflow": (5, 0), "band-overflow": (5, 37), "empty-slots": (20, 0),
         "band-empty-slots": (20, 11), "every-tile": (N_TILES, 0)}


def synthetic_round(case: str, pos_derivs: bool) -> tuple:
    """A peel state and a round's raced channels for CASES[case] ->
    (tiles {channel: [N_TILES, 8, 128]}, ok [N_TILES + 1, 8, 128], seed
    depths, pad tile, t0, cap, raced {channel: [cap, 8, 128]})."""
    cap, t0 = CASES[case]
    gen = torch.Generator().manual_seed(sorted(CASES).index(case) + 10 * pos_derivs)
    active = active_channels(pos_derivs)
    tiles = _channels(gen, N_TILES, active)
    # 12 tiles hold failing winners (the first two have no winner at all);
    # elsewhere ok is false only where there is no winner
    ok_p = torch.rand((N_TILES + 1, 8, 128), generator=gen) < 0.95
    calm = torch.ones(N_TILES + 1, dtype=torch.bool)
    calm[torch.randperm(N_TILES, generator=gen)[:12]] = False
    ok_p[:N_TILES] |= calm[:N_TILES, None, None] & (tiles["tri"] >= 0)
    init_tiles = torch.rand((N_TILES, 8, 128), generator=gen)
    pad_tile = torch.tensor(3, dtype=torch.int32)
    return tiles, ok_p, init_tiles, pad_tile, t0, cap, _channels(gen, cap, active)


@pytest.mark.parametrize("pos_derivs", [True, False], ids=["dpos", "no-dpos"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_round_matches_the_dict_round(case, pos_derivs):
    tiles, ok_p, init_tiles, pad_tile, t0, cap, raced = synthetic_round(case, pos_derivs)
    old = {n: torch.cat([a, torch.zeros_like(a[:1])]) for n, a in tiles.items()}
    want = _dict_round(old, ok_p, init_tiles, pad_tile, t0, cap,
                       {n: a.clone() for n, a in raced.items()})
    names = _peel_channels(tiles)
    assert names[:2] == INT_CHANNELS and names[PEEL_DEPTH] == "depth"
    assert sorted(names) == sorted(tiles)
    state = torch.stack([tiles[n].view(torch.float32) for n in names])

    before = CLIP_WORKLIST_KERNEL.launches, CLIP_MERGE_KERNEL.launches
    ok0 = ok_p.clone()
    ids, race_ids, demand, seed, maxd = _clip_worklist(state, ok_p, init_tiles, pad_tile,
                                                       t0, cap)
    for got, ref in zip((ids, race_ids, demand), want[:3]):
        assert got.dtype == torch.int32 and torch.equal(got, ref.to(torch.int32))
    assert torch.equal(_bits(seed), _bits(want[3])) and torch.equal(_bits(maxd), _bits(want[4]))
    live = ids < N_TILES
    n_live, n_demand = int(live.sum()), int(demand)
    assert n_live == min(n_demand, cap) and n_demand > 0
    assert torch.equal(ids[:n_live], ids[:n_live].sort().values)
    if n_demand > cap:
        assert "overflow" in case
    else:
        assert n_live < cap or case == "every-tile"

    out = {n: a.clone() for n, a in raced.items()}
    _clip_merge(state, ok_p, ids, out)
    for c, n in enumerate(names):
        assert torch.equal(state[c].view(torch.int32), _bits(old[n][:N_TILES])), n
        # live slots hold the merged winner; empty slots are left alone
        assert torch.equal(_bits(out[n])[live], _bits(want[5][n])[live]), n
        assert torch.equal(_bits(out[n])[~live], _bits(raced[n])[~live]), n
    assert torch.equal(ok_p, ok0)
    # the plain forms launch nothing
    assert (CLIP_WORKLIST_KERNEL.launches, CLIP_MERGE_KERNEL.launches) == before


def test_merge_keeps_every_bit_of_the_int_channels():
    """Every pattern of PATTERNS, in both the state and the raced
    channels, comes out of the merge unchanged where it is kept."""
    k = len(PATTERNS)
    names = active_channels(False)
    n_tiles = k + 1
    gen = torch.Generator().manual_seed(5)
    tiles = _channels(gen, n_tiles, names)
    raced = _channels(gen, k, names)
    for ch in (tiles, raced):
        ch["material"][: k] = PATTERNS[:, None, None]
        ch["tri"][: k, :, :64] = PATTERNS[:, None, None]
    # the first half of each tile's pixels fail where the winner is one
    ok_p = torch.ones((n_tiles + 1, 8, 128), dtype=torch.bool)
    ok_p[:, :, :64] = False
    ids = torch.arange(k, dtype=torch.int32)
    state = torch.stack([tiles[n].view(torch.float32) for n in _peel_channels(tiles)])
    out = {n: a.clone() for n, a in raced.items()}
    _clip_merge(state, ok_p, ids, out)
    failed = (tiles["tri"][:k] >= 0) & ~ok_p[:k]
    for c, n in enumerate(_peel_channels(tiles)):
        want = torch.where(failed, _bits(raced[n]), _bits(tiles[n][:k]))
        assert torch.equal(state[c, :k].view(torch.int32), want), n
        assert torch.equal(_bits(out[n]), want), n
        assert torch.equal(state[c, k].view(torch.int32), _bits(tiles[n][k])), n
    assert torch.equal(state[1, :k, 0, 0].view(torch.int32),
                       torch.where(failed[:, 0, 0], raced["material"][:, 0, 0], PATTERNS))
