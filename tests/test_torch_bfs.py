"""The port's trace_shadow_bfs (ops/bvh.py, the level-synchronous
frontier traversal) vs the JAX package's, on the reference's own test
(tests/test_bvh.py::test_bfs_matches_walk_anyhit): the same sphere
mesh, the same seed-21 rays with mixed t_max (a fifth dead). Hits and the
overflow count equal the reference's, and the hits equal the port's
plain any-hit walk (trace_occlusion_plain), on the single-chunk path,
on the chunked path (_BFS_CHUNK 256: seven chunks and padding) and
under chunk=256, cap_factor=1, where the frontier overflows and both
packages report the same positive count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.models import make_sphere_mesh
from transmission_renderer_tpu.ops import bvh as jbvh
from transmission_renderer_tpu_torch import ops
from transmission_renderer_tpu_torch.ops import bvh, bvh_packet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    pos, _, _, tri = make_sphere_mesh(9, 18)
    tri = tri.astype(np.int32)
    rng = np.random.default_rng(21)
    n = 1777
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(
        rng.random(n) < 0.2, 0.0,
        np.where(rng.random(n) < 0.5, 1e4, rng.uniform(0.1, 3.0, n)),
    ).astype(np.float32)
    ref_args = (jbvh.build_bvh(tri, pos), jnp.asarray(tri), jnp.asarray(pos),
                jnp.asarray(o), jnp.asarray(d))
    pb = bvh.build_bvh(tri, pos, device="cpu")
    t_tri, t_pos = torch.from_numpy(tri), torch.from_numpy(pos)
    port_args = (pb, t_tri, t_pos, torch.from_numpy(o), torch.from_numpy(d))
    walk = bvh.trace_occlusion_plain(
        pb, bvh_packet.packet_walk_table(pb, t_tri, t_pos),
        bvh_packet.ray_planes(port_args[3], port_args[4], torch.from_numpy(t_max)))
    return ref_args, port_args, t_max, walk


@pytest.mark.parametrize("path", ["single chunk", "chunked", "overflowing"])
def test_bfs_matches_reference_and_walk(case, path, monkeypatch):
    ref_args, port_args, t_max, walk = case
    kw = {"chunk": 256, "cap_factor": 1} if path == "overflowing" else {}
    if path == "chunked":
        monkeypatch.setattr(jbvh, "_BFS_CHUNK", 256)
        monkeypatch.setattr(bvh, "_BFS_CHUNK", 256)
    ref_hit, ref_over = jbvh.trace_shadow_bfs(*ref_args, t_max=jnp.asarray(t_max), **kw)
    hit, over = ops.trace_shadow_bfs(*port_args, t_max=torch.from_numpy(t_max), **kw)
    assert hit.dtype == torch.bool and hit.shape == (1777,)
    assert over.dtype == torch.int32 and over.shape == ()
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
    assert int(over) == int(ref_over)
    if path == "overflowing":
        assert int(over) > 0
    else:
        assert int(over) == 0
        assert torch.equal(hit, walk)
    assert walk.any() and not walk.all() and not hit[torch.from_numpy(t_max) == 0].any()


def test_bfs_scalar_tmax_and_ray_shape(case):
    """A scalar t_max and rays shaped [a, b, 3]: hits shaped [a, b], equal
    to the reference's."""
    ref_args, port_args, _, _ = case
    o, d = port_args[3][:1776].reshape(16, 111, 3), port_args[4][:1776].reshape(16, 111, 3)
    hit, over = bvh.trace_shadow_bfs(*port_args[:3], o, d, t_max=2.5)
    ref_hit, ref_over = jbvh.trace_shadow_bfs(*ref_args[:3], jnp.asarray(o.numpy()),
                                              jnp.asarray(d.numpy()), t_max=2.5)
    assert hit.shape == (16, 111) and int(over) == int(ref_over) == 0
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
