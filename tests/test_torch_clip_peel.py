"""The clip peel's re-race bookkeeping (render/frame.py: _clip_worklist,
_clip_merge, the rounds handle _clip_rounds; csrc/clip_peel.cu on the
card) in its plain form, against the per-channel dict round it replaces
and the round-by-round loop of the per-round handles.

A synthetic peel state (random winners, a random ok state, tiles with no
winner, int channels holding NaN and denormal bit patterns) goes through
one round both ways: the stacked state's worklist and merge, and the
former code, which kept each channel as an [n_tiles + 1, 8, 128] tensor
(row n_tiles the empty slots' write target) and updated it by gather,
where and index-put. Both give the same slot ids, raced tile ids, demand,
kernel-1 inputs and state bit for bit, and the merged winner lands in the
raced channels of every live slot, as the alpha test reads them.

The same states, over a small frame of random triangles in two draw
classes and the stress scene's materials and atlas, go through three
re-race rounds (a shrinking cap in the last) two ways: the rounds handle's
plain version and the round-by-round loop of the per-round handles. Both
give the same state, ok, per-round demand and recorded kernel-1 calls bit
for bit. The card kernels and the C entry are held to these plain
versions in tests/test_torch_cuda.py and tests/test_torch_card_hd.py."""

import functools

import numpy as np
import pytest
import torch

from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
from transmission_renderer_tpu_torch.ops import raster, raster_gbuf
from transmission_renderer_tpu_torch.ops.raster_gbuf import INT_CHANNELS, active_channels
from transmission_renderer_tpu_torch.render.frame import (
    CLIP_ALPHA_KERNEL,
    CLIP_MERGE_KERNEL,
    CLIP_ROUNDS_KERNEL,
    CLIP_WORKLIST_KERNEL,
    PEEL_DEPTH,
    _clip_alpha_test,
    _clip_merge,
    _clip_rounds,
    _clip_worklist,
    _peel_channels,
)
from transmission_renderer_tpu_torch.scene.camera import look_at_rh, perspective_matrix_reversed

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


# ---------------------------------------------------------------------------
# the rounds handle: every re-race round of a peel from one call
# ---------------------------------------------------------------------------

# 4 x 16 tiles of the binned grid: room for the band cases' t0 + N_TILES
FRAME_W, FRAME_H = 512, 128
N_GRID = (FRAME_W // 128) * (FRAME_H // 8)
TIERS = ((8, 4096), (128, 512), (2048, 64), (0, 16))


@functools.lru_cache(maxsize=None)
def _frame_inputs() -> tuple:
    """(scene, payload, tile_start): random triangles (some crossing the
    camera plane, both windings) in two draw classes binned over the grid,
    their material ids the stress scene's, whose materials and atlas the
    alpha test reads."""
    rng = np.random.default_rng(17)
    n_v, n_t = 60, 80
    pv = perspective_matrix_reversed(FRAME_W, FRAME_H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0))
    pos = rng.uniform(-2, 2, (n_v, 3)).astype(np.float32)
    pos[:4, 2] = rng.uniform(4.0, 7.0, 4)
    nrm = rng.normal(size=(n_v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 2, (n_v, 2)).astype(np.float32)
    tris = rng.integers(0, n_v, (n_t, 3))
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                & (tris[:, 0] != tris[:, 2])].astype(np.int32)
    scene = build_stress_scene(grid=1).finish_bundle(device=torch.device("cpu"))[0]
    mat = rng.integers(0, scene.materials.tex_diffuse.shape[0], len(tris)).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, len(tris)).astype(np.float32)
    cls = torch.from_numpy(rng.integers(0, 2, len(tris)).astype(np.int32))
    clip = np.concatenate([pos, np.ones((n_v, 1), np.float32)], -1) @ pv.T
    t = torch.from_numpy
    setup = raster.setup_triangles(t(clip.astype(np.float32)), t(tris),
                                   torch.ones(len(tris), dtype=torch.bool), FRAME_W, FRAME_H,
                                   128, 8)
    bins = raster.bin_triangles(setup, FRAME_W // 128, FRAME_H // 8, 2, cls, 2, TIERS)
    records = raster_gbuf.pack_gbuf_payload(setup, t(tris), t(mat), t(scale), t(pos), t(nrm),
                                            t(uv), cls)
    return scene, raster_gbuf.gather_gbuf_payload(records, bins), bins.tile_start


def _rounds_case(case: str, pos_derivs: bool) -> tuple:
    """CASES[case]'s synthetic state for the rounds handle: (scene, state,
    ok, seed depths, pad tile, t0, caps, payload, tile_start, big count,
    w, h, pass class, pos_derivs, n_tiles_global), its material ids
    the scene's."""
    scene, payload, tile_start = _frame_inputs()
    tiles, ok_p, init_tiles, pad_tile, t0, cap, _ = synthetic_round(case, pos_derivs)
    tiles["material"] = torch.remainder(tiles["material"], scene.materials.tex_diffuse.shape[0])
    state = torch.stack([tiles[n].view(torch.float32) for n in _peel_channels(tiles)])
    # seeds below the triangles' depths (~2e-3 at the camera's distance
    # in reversed Z), so that the rounds' races find winners
    init_tiles = init_tiles * 1e-3
    return (scene, state, ok_p, init_tiles, pad_tile, t0, (cap, cap, max(cap // 3, 1)),
            payload, tile_start, 0, FRAME_W, FRAME_H, 1, pos_derivs, N_GRID if t0 else None)


def _round_by_round(scene, state, ok_p, init_tiles, pad_tile, t0, caps, payload, tile_start,
                    big_count, w, h, pass_class, pos_derivs, n_tiles_global):
    """The rounds as the peel ran them before the rounds handle: a loop of the
    per-round handles, updating ``state`` and ``ok_p`` -> [rounds] int32."""
    n_tiles = state.shape[1]
    demand = []
    for cap in caps:
        ids, race_ids, d, seed, maxd = _clip_worklist(state, ok_p, init_tiles, pad_tile, t0,
                                                      cap)
        demand.append(int(d))
        new = raster_gbuf.rasterize_gbuffer_tiles(
            payload, race_ids, tile_start, big_count, w, h, init_depth_tiles=seed,
            max_depth_tiles=maxd, pass_class=pass_class, pos_derivs=pos_derivs,
            n_tiles_global=n_tiles_global)
        _clip_merge(state, ok_p, ids, new)
        _clip_alpha_test(scene, new, ids, n_tiles, ok_p)
    return torch.tensor(demand, dtype=torch.int32)


def _recording(fn, args) -> tuple:
    """fn(*args) with kernel 1's calls recorded -> (result, calls)."""
    raster_gbuf.KERNEL.recorder = []
    try:
        out = fn(*args)
    finally:
        calls, raster_gbuf.KERNEL.recorder = raster_gbuf.KERNEL.recorder, None
    return out, calls


def _same_call(a, b) -> bool:
    """Two recorded kernel-1 calls equal, tensors bit for bit."""
    (args_a, kw_a), (args_b, kw_b) = a, b
    if len(args_a) != len(args_b) or kw_a.keys() != kw_b.keys():
        return False
    for x, y in zip(list(args_a) + list(kw_a.values()), list(args_b) + list(kw_b.values())):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(_bits(x), _bits(y))):
                return False
        elif x is not y and x != y:
            return False
    return True


@pytest.mark.parametrize("pos_derivs", [True, False], ids=["dpos", "no-dpos"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_rounds_match_the_round_by_round_loop(case, pos_derivs):
    """The rounds handle's plain version against the loop of the per-round plain
    handles, over copies of one state: the state, ok, every round's demand
    and the recorded kernel-1 calls (payload, raced tile ids, seeds, peel
    bounds, pass class, channels, the binned grid) equal bit for bit; the
    rounds race failing tiles, and the plain forms launch nothing."""
    call = _rounds_case(case, pos_derivs)
    handles = (CLIP_ROUNDS_KERNEL, CLIP_WORKLIST_KERNEL, CLIP_MERGE_KERNEL, CLIP_ALPHA_KERNEL,
               raster_gbuf.KERNEL)
    before = [h.launches for h in handles]
    runs = []
    for fn in (_clip_rounds, _round_by_round):
        args = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in call)
        demand, calls = _recording(fn, args)
        runs.append((args[1], args[2], demand, calls))
    (state, ok_p, demand, calls), (state_r, ok_r, demand_r, calls_r) = runs
    assert demand.dtype == torch.int32 and torch.equal(demand, demand_r)
    assert torch.equal(_bits(state), _bits(state_r)) and torch.equal(ok_p, ok_r)
    assert len(calls) == len(calls_r) == len(call[6])
    assert all(_same_call(a, b) for a, b in zip(calls, calls_r))
    assert calls[0][1]["n_tiles_global"] == N_GRID and int(demand[0]) > 0
    assert [int(a[0][1].shape[0]) for a in calls] == list(call[6])
    assert not torch.equal(_bits(state), _bits(call[1])) and not torch.equal(ok_p, call[2])
    assert [h.launches for h in handles] == before
