"""The reference's public names on the port, each against the JAX package.

- Every name that a reference package's ``__init__`` exports (the top
  level's ``RenderConfig``, render, scene, pbr, utils, models and
  parallel) imports from the port's package of the same path.
- ``build_draw_list`` and ``scene_flags`` from a frozen Scene equal the
  reference's on the same scene, and the port's own ``finish_bundle``.
- ``render_frame`` takes the reference's parameters in its order: a
  positional call shaped for the reference (``ggx_lut`` sixth) gives the
  keyword call's frame, with ``flags=None`` meaning alpha clip and
  transmission on.
- ``similarity_identity`` / ``similarity_mul`` / ``similarity_to_mat4``,
  the interleaved ``lottes_tonemap`` (also equal to the planes form bit
  for bit), ``device_sync`` (nothing to wait on for CPU tensors), and ``save_png`` /
  ``load_png`` across the two packages' codecs, on seeded inputs.
"""

import ast
import importlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.pbr import tonemap as jtm
from transmission_renderer_tpu.render import frame as jframe
from transmission_renderer_tpu.scene import types as jtypes
from transmission_renderer_tpu.utils import image_io as jio
from transmission_renderer_tpu_torch import models, render, scene, utils
from transmission_renderer_tpu_torch.config import RenderConfig
from transmission_renderer_tpu_torch.pbr import tonemap
from transmission_renderer_tpu_torch.utils import profiling

torch.set_num_threads(1)

REF_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "transmission_renderer_tpu")


def _exported(path: str) -> list:
    """The names a reference ``__init__.py`` imports for export."""
    tree = ast.parse(open(path).read())
    return [a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
            for a in n.names]


@pytest.mark.parametrize("package", ["", "render", "scene", "pbr", "utils", "models",
                                     "parallel"])
def test_reference_names_import_from_the_port(package):
    ref_init = os.path.join(REF_ROOT, package, "__init__.py")
    names = _exported(ref_init)
    assert names
    port = importlib.import_module(
        "transmission_renderer_tpu_torch" + (f".{package}" if package else ""))
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    for n in names:  # the form an application writes
        exec(f"from {port.__name__} import {n}", {})


def _scenes():
    from transmission_renderer_tpu.models import procedural as jproc

    return {"test": (jproc.build_test_scene, models.build_test_scene),
            "stress": (lambda: jproc.build_stress_scene(grid=2),
                       lambda: models.build_stress_scene(grid=2))}


@pytest.mark.parametrize("name", ["test", "stress"])
def test_device_scene_forms_equal_reference(name):
    jbuild, pbuild = _scenes()[name]
    jscene = jbuild().finish_bundle()[0]
    pscene, pdl, pflags = pbuild().finish_bundle(device="cpu")
    dl = render.build_draw_list(pscene)
    want = jframe.build_draw_list(jscene)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(dl, f).numpy(), np.asarray(getattr(want, f)))
        assert torch.equal(getattr(dl, f), getattr(pdl, f)), f
    flags = render.scene_flags(pscene)
    assert tuple(flags) == tuple(jframe.scene_flags(jscene)) and flags == pflags


def test_render_frame_takes_the_references_order():
    assert list(inspect.signature(render.render_frame).parameters) == list(
        inspect.signature(jframe.render_frame).parameters)
    cfg = RenderConfig(width=64, height=40, tile_w=32, tile_h=8, max_tris_per_tile=1024,
                       max_tiles_per_tri=16, max_big_tris=32)
    s, dl, _ = models.build_test_scene().finish_bundle(device="cpu")
    rig = scene.CameraRig()
    params = render.make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir(), device="cpu")
    from transmission_renderer_tpu_torch.pbr import pack_lights, point_light

    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    lut = torch.from_numpy(utils.default_ggx_lut(32))
    shaped = render.render_frame(s, dl, params, lights, cfg, lut)
    every = render.SceneFlags(has_alpha_clip=True, has_transmission=True)
    assert torch.equal(shaped, render.render_frame(s, dl, params, lights, cfg, ggx_lut=lut,
                                                   flags=every))
    assert bool(torch.isfinite(shaped).all()) and shaped.shape == (40, 64, 3)


def _similarity(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32), q)


def test_similarity_helpers_match_reference():
    rng = np.random.default_rng(5)
    a, b = _similarity(rng, 32), _similarity(rng, 32)
    ja, jb = (jtypes.Similarity(*map(jnp.asarray, x)) for x in (a, b))
    pa, pb = (scene.Similarity(*map(torch.from_numpy, x)) for x in (a, b))
    ident = scene.similarity_identity((3,), device="cpu")
    for got, want in zip(ident, jtypes.similarity_identity((3,))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(scene.similarity_to_mat4(pa).numpy(),
                                  np.asarray(jtypes.similarity_to_mat4(ja)))
    # the reference's compiler contracts the products into fmas, as
    # similarity_apply does; quat_mul's four-term sums may round apart
    want = jax.jit(jtypes.similarity_mul)(ja, jb)
    for got, w in zip(scene.similarity_mul(pa, pb), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    one = scene.similarity_mul(scene.similarity_identity((32,), device="cpu"), pb)
    for got, w in zip(one, pb):
        np.testing.assert_array_equal(got.numpy(), w.numpy())


def test_interleaved_tonemap():
    """Equal to the planes form bit for bit; atol 1e-6 against the
    reference (pow may differ by an ulp)."""
    rng = np.random.default_rng(3)
    hdr = rng.exponential(1.5, (48, 64, 3)).astype(np.float32)
    hdr[:4] = 0.0
    hdr[4:8, :, 0] = -1e-3
    hdr[8:10] *= 40.0
    p = tonemap.bake_lottes_params()
    got = tonemap.lottes_tonemap(torch.from_numpy(hdr), p)
    planes = tonemap.lottes_tonemap_planes(tuple(torch.from_numpy(hdr).unbind(-1)), p)
    assert torch.equal(got, torch.stack(planes, -1))
    want = np.asarray(jtm.lottes_tonemap(jnp.asarray(hdr), jtm.bake_lottes_params()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_device_sync_waits_on_nothing_for_cpu_tensors():
    """device_sync takes a tensor or a nested tuple / list of them and
    waits on nothing for CPU tensors."""
    assert profiling.device_sync(torch.zeros(3)) is None
    assert profiling.device_sync((torch.zeros(2), [torch.ones(1)])) is None


def test_png_helpers_cross_the_codecs(tmp_path):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    linear = rng.uniform(-0.1, 1.1, (9, 13, 3)).astype(np.float32)
    utils.save_png(str(tmp_path / "port.png"), img)
    jio.save_png(str(tmp_path / "ref.png"), img)
    for path in ("port.png", "ref.png"):
        got = utils.load_png(str(tmp_path / path))
        np.testing.assert_array_equal(got, jio.load_png(str(tmp_path / path)))
        np.testing.assert_array_equal(got[..., :3], img)
    utils.save_png(str(tmp_path / "f_port.png"), linear)
    jio.save_png(str(tmp_path / "f_ref.png"), linear)
    np.testing.assert_array_equal(utils.load_png(str(tmp_path / "f_port.png")),
                                  jio.load_png(str(tmp_path / "f_ref.png")))
