"""Port materialised binning and the visibility raster (kernel 6's plain
version, in both walk orders) vs the JAX package.

The scenes of tests/test_raster_pallas.py at W=256, H=64 with 8x128
tiles: random triangles, an init-depth seed, a floor plane whose
full-screen bbox sends it to the big list, and class-filtered passes
over class-flagged records. The kernel-6 order is held against
``rasterize_pallas(interpret=True)``, the XLA-raster order against
``ops/raster.py::rasterize``, also with 32x8 tiles and with bins cut
below a tile's count (the triangles the reference drops must be the
ones the port drops). Tolerances are test_raster_pallas.py's: triangle
ids equal, depth within 1e-7, barycentrics within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.ops import raster as jraster
from transmission_renderer_tpu.ops import raster_pallas as jpallas
from transmission_renderer_tpu.scene.camera import look_at_rh, perspective_matrix_reversed
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.ops import raster, raster_vis

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

W, H = 256, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _project(positions, pv):
    ph = np.concatenate([positions, np.ones((len(positions), 1), np.float32)], -1)
    return (ph @ pv.T).astype(np.float32)


def _random_scene(seed, n_tris=25):
    """test_raster_pallas.py's scene: large triangles over 30 points."""
    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0))
    pts = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    tris = rng.integers(0, 30, (n_tris, 3))
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                & (tris[:, 0] != tris[:, 2])]
    return _project(pts, pv), tris.astype(np.int32)


def _small_scene(seed, n_tris=160):
    """Many small overlapping triangles (crowded bins)."""
    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0))
    centres = rng.uniform(-1.5, 1.5, (n_tris, 1, 3)) * [1.5, 0.4, 1.0] + [0.0, 1.0, 0.0]
    pts = (centres + rng.uniform(-0.3, 0.3, (n_tris, 3, 3))).reshape(-1, 3)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    return _project(pts.astype(np.float32), pv), tris


def _big_scene():
    """A floor plane under a camera close to it (a vertex behind the
    camera gives its triangles full-screen bboxes) and random triangles."""
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 0.0), (0.0, 0.5, -3.0), (0, 1, 0))
    s = 50.0
    plane = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.5, 1.5, (20, 3)).astype(np.float32) + [0.0, 0.8, -3.0]
    tris = rng.integers(0, 20, (30, 3)) + 4
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                & (tris[:, 0] != tris[:, 2])]
    tris = np.concatenate([[[0, 2, 1], [0, 3, 2]], tris]).astype(np.int32)
    return _project(np.concatenate([plane, pts]), pv), tris


SCENES = {"random": lambda: _random_scene(0), "init": lambda: _random_scene(3),
          "big": _big_scene, "dense": lambda: _small_scene(7)}


def _setups(clip, tris, tw=128, th=8):
    ref = jraster.setup_triangles(jnp.asarray(clip), jnp.asarray(tris),
                                  jnp.ones(len(tris), bool), W, H, tw, th)
    got = raster.setup_triangles(_t(clip), _t(tris), torch.ones(len(tris), dtype=torch.bool),
                                 W, H, tw, th)
    return ref, got


def _init_depth(name):
    if name != "init":
        return None
    init = np.zeros((H, W), np.float32)
    init[:, : W // 4] = 0.9  # those pixels must stay empty
    # the rest races against a ramp through the scene's own depths
    init[:, W // 4 :] = np.linspace(0.0, 4e-3, W - W // 4, dtype=np.float32)
    return init


def _compare(got: raster.VisibilityBuffer, ref):
    tri = np.asarray(ref.tri_id)
    np.testing.assert_array_equal(got.tri_id.numpy(), tri)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=1e-7, rtol=0)
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(ref.bary), atol=1e-6, rtol=0)
    assert (tri >= 0).sum() > 100


def _bins(ref_setup, setup, tw, th, k=8, cap=64, nbig=16):
    tx, ty = -(-W // tw), -(-H // th)
    return (jraster.bin_triangles(ref_setup, tx, ty, k, cap, nbig),
            raster.bin_triangles_materialized(setup, tx, ty, k, cap, nbig))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_materialized_binning_exact(name):
    """Per-tile lists, capped counts, the big list and its count, the raw
    maximum: equal to the reference's ``materialize=True`` binning."""
    ref_setup, setup = _setups(*SCENES[name]())
    ref, got = _bins(ref_setup, setup, 128, 8, k=4, cap=6, nbig=1)
    for f in ("tile_tri_ids", "tile_tri_count", "big_tri_ids", "big_tri_count",
              "tile_start", "sorted_tri_ids", "max_bin_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel6_order_matches_rasterize_pallas(name):
    clip, tris = SCENES[name]()
    ref_setup, setup = _setups(clip, tris)
    ref_bins, bins = _bins(ref_setup, setup, 128, 8)
    init = _init_depth(name)
    ref = jpallas.rasterize_pallas(ref_setup, ref_bins, W, H, interpret=True,
                                   init_depth=None if init is None else jnp.asarray(init))
    got = raster_vis.rasterize_pallas(setup, bins, W, H,
                                      init_depth=None if init is None else _t(init))
    _compare(got, ref)
    if name == "big":  # the floor plane's two triangles ride the big list
        assert bins.big_tri_ids[:2].tolist() == [0, 1]


@pytest.mark.parametrize("tiles", [(128, 8), (32, 8)])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_xla_order_matches_rasterize(name, tiles):
    clip, tris = SCENES[name]()
    tw, th = tiles
    ref_setup, setup = _setups(clip, tris, tw, th)
    ref_bins, bins = _bins(ref_setup, setup, tw, th)
    init = _init_depth(name)
    ref = jraster.rasterize(ref_setup, ref_bins, W, H, tw, th,
                            init_depth=None if init is None else jnp.asarray(init))
    got = raster_vis.rasterize(setup, bins, W, H, tw, th,
                               init_depth=None if init is None else _t(init))
    _compare(got, ref)


@pytest.mark.parametrize("pass_class", [0, 1])
def test_kernel6_order_pass_class(pass_class):
    """Class-flagged records with a pass filter, as rasterize_pallas runs
    them with an injected payload."""
    clip, tris = SCENES["dense"]()
    ref_setup, setup = _setups(clip, tris)
    ref_bins, bins = _bins(ref_setup, setup, 128, 8)
    cls = np.random.default_rng(5).integers(0, 2, len(tris)).astype(np.int32)
    ref_pay = jpallas.gather_bin_payload(ref_setup, ref_bins, jnp.asarray(cls))
    pay = raster_vis.gather_bin_payload(setup, bins, _t(cls))
    ref_rec = np.asarray(ref_pay[0]).reshape(-1, 16)[: pay[0].shape[0]]
    np.testing.assert_array_equal(pay[0].numpy(), ref_rec)
    ref = jpallas.rasterize_pallas(ref_setup, ref_bins, W, H, interpret=True,
                                   pass_class=pass_class, payload=ref_pay)
    got = raster_vis.rasterize_pallas(setup, bins, W, H, pass_class=pass_class, payload=pay)
    _compare(got, ref)


def test_xla_order_drops_what_the_reference_drops():
    """Bins cut below the busiest tiles' counts: the XLA order walks the
    first max_tris_per_tile triangles of each run, so it loses exactly the
    reference's, and the kernel-6 order (uncut runs) keeps them."""
    clip, tris = SCENES["dense"]()
    ref_setup, setup = _setups(clip, tris)
    ref_bins, bins = _bins(ref_setup, setup, 128, 8, cap=10)
    assert int(bins.max_bin_count) > 10
    ref = jraster.rasterize(ref_setup, ref_bins, W, H, 128, 8)
    got = raster_vis.rasterize(setup, bins, W, H, 128, 8)
    _compare(got, ref)
    full = raster_vis.rasterize_pallas(setup, bins, W, H)
    assert int((full.tri_id != got.tri_id).sum()) > 50


def test_bridge_carries_vis_buffer_and_bins():
    """bridge.vis_buffer / bridge.tile_bins give the reference's arrays
    back as port tensors, and the port rasterises the bridged bins."""
    clip, tris = SCENES["big"]()
    ref_setup, setup = _setups(clip, tris)
    ref_bins, _ = _bins(ref_setup, setup, 128, 8)
    ref = jraster.rasterize(ref_setup, ref_bins, W, H, 128, 8)
    vis = bridge.vis_buffer(ref, device="cpu")
    bins = bridge.tile_bins(ref_bins, device="cpu")
    assert bins.tile_tri_ids.dtype == torch.int32
    _compare(vis, ref)
    _compare(raster_vis.rasterize(setup, bins, W, H, 128, 8), ref)
