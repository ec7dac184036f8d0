"""The port's glTF/GLB loader (scene/gltf.py) vs the JAX package's.

The documents are the reference's own test documents: every test of
tests/test_gltf.py runs once in a directory of its own (so the
reference's assertions hold on the way), and each .gltf / .glb it wrote,
plus tests/assets/multi.glb, is loaded by both packages' load_gltf
(defaults, and base_scale 2 with roughness_override 0.3). Every staging
list of the SceneBuilder, every Scene, DrawList and SceneFlags output of
finish_bundle (the bf16 atlas by bit pattern) must be equal bit for bit;
a document the reference rejects (a non-triangle primitive) is rejected
by the port with the same ValueError. JPEG images (tests/assets/jpeg.glb's,
one from a ``data:`` URI, one from a bufferView and one from a ``.jpg``
file) load through both packages with every array equal.
"""

import base64
import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax
import test_gltf as ref_docs
from transmission_renderer_tpu.scene.builder import SceneBuilder as JBuilder
from transmission_renderer_tpu.scene.gltf import GltfDocument as JDocument
from transmission_renderer_tpu.scene.gltf import load_gltf as jload
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.scene import gltf as pgltf
from transmission_renderer_tpu_torch.scene.builder import SceneBuilder

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "assets", "multi.glb")
OPTIONS = {"default": {}, "scaled": {"base_scale": 2.0, "roughness_override": 0.3}}


@pytest.fixture(scope="module")
def documents(tmp_path_factory):
    """{name: path} of every document tests/test_gltf.py writes, and the
    multi.glb fixture."""
    docs = {"multi.glb": FIXTURE}
    for name, fn in inspect.getmembers(ref_docs, inspect.isfunction):
        if not name.startswith("test_"):
            continue
        d = tmp_path_factory.mktemp(name)
        fn(d)
        for f in sorted(os.listdir(d)):
            if f.endswith((".gltf", ".glb")):
                docs[f"{name}/{f}"] = str(d / f)
    return docs


def _load(load, builder, path, opts):
    try:
        load(path, builder, **opts)
    except ValueError as e:
        return str(e)
    return None


def _host(x):
    return np.asarray(x)


def _assert_tree_equal(got, want, where):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if hasattr(b, "_fields"):
            _assert_tree_equal(a, b, f"{where}.{name}")
        elif isinstance(b, (bool, int, float, tuple, type(None))):
            assert a == b, (where, name, a, b)
        else:
            b = bridge.to_tensor(np.asarray(b), "cpu")
            assert a.dtype == b.dtype and a.shape == b.shape, (where, name)
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), (where, name)


def test_documents_cover_the_reference_tests(documents):
    assert len(documents) >= 12
    assert any(p.endswith(".glb") for p in documents)


def _assert_loads_equal(name, path, opts):
    """The same staging lists and finish_bundle outputs bit for bit, or
    the same rejection."""
    jb, pb = JBuilder(), SceneBuilder()
    j_err = _load(jload, jb, path, opts)
    p_err = _load(pgltf.load_gltf, pb, path, opts)
    assert p_err == j_err, name
    if j_err is not None:
        return
    for field in ("positions", "normals", "uvs", "indices", "prim_sphere",
                  "inst_translation", "inst_rotation"):
        for a, b in zip(getattr(pb, field), getattr(jb, field), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {field}")
    for field in ("prim_bucket", "prim_first_tri", "prim_tri_count", "inst_scale",
                  "inst_primitive", "inst_material", "materials"):
        assert getattr(pb, field) == getattr(jb, field), (name, field)
    j_scene, j_dl, j_flags = jax.tree_util.tree_map(_host, jb.finish_bundle())
    p_scene, p_dl, p_flags = pb.finish_bundle(device="cpu")
    _assert_tree_equal(p_scene, j_scene, f"{name} scene")
    _assert_tree_equal(p_dl, j_dl, f"{name} draw list")
    assert tuple(p_flags) == tuple(j_flags), name


@pytest.mark.parametrize("opts", sorted(OPTIONS))
def test_loader_matches_reference(documents, opts):
    """Every document: the same staging lists and finish_bundle outputs
    bit for bit, or the same rejection."""
    for name, path in documents.items():
        _assert_loads_equal(name, path, OPTIONS[opts])


def test_accessors_and_images_match_reference():
    """GltfDocument on multi.glb: every accessor and image decode."""
    jd, pd = JDocument.load(FIXTURE), pgltf.GltfDocument.load(FIXTURE)
    for i in range(len(jd.doc["accessors"])):
        a, b = pd.read_accessor(i), jd.read_accessor(i)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(jd.doc["images"]) >= 1
    for i in range(len(jd.doc["images"])):
        np.testing.assert_array_equal(pd.read_image(i), jd.read_image(i))


def test_node_transforms_match_reference(documents):
    """_flatten_nodes of every document, bit for bit."""
    from transmission_renderer_tpu.scene.gltf import _flatten_nodes as jflatten

    for name, path in documents.items():
        doc = pgltf.GltfDocument.load(path).doc
        for (pt, pq, ps), (jt, jq, js) in zip(pgltf._flatten_nodes(doc), jflatten(doc),
                                              strict=True):
            np.testing.assert_array_equal(pt, jt, err_msg=name)
            np.testing.assert_array_equal(pq, jq, err_msg=name)
            assert ps == js, name


def test_jpeg_image_names_its_roadmap_item(tmp_path):
    """Once the refusal of a JPEG image (ROADMAP queue 1, item 9), now its
    parity: jpeg.glb's scene as a .gltf whose three JPEG images come from
    a ``data:`` URI, a bufferView and a ``.jpg`` file beside it loads
    through both packages with every image and every array equal."""
    from card_defs import glb_images, glb_parts

    with open(os.path.join(os.path.dirname(__file__), "assets", "jpeg.glb"), "rb") as f:
        glb = f.read()
    doc, blob = glb_parts(glb)
    jpegs = glb_images(glb)
    doc["images"][0] = {"uri": "data:image/jpeg;base64," + base64.b64encode(jpegs[0]).decode()}
    (tmp_path / "leaf.jpg").write_bytes(jpegs[2])
    doc["images"][2] = {"uri": "leaf.jpg"}
    (tmp_path / "jpeg.bin").write_bytes(blob)
    doc["buffers"] = [{"uri": "jpeg.bin", "byteLength": len(blob)}]
    path = tmp_path / "jpeg.gltf"
    path.write_text(json.dumps(doc))
    jd, pd = JDocument.load(str(path)), pgltf.GltfDocument.load(str(path))
    for i in range(3):
        np.testing.assert_array_equal(pd.read_image(i), jd.read_image(i))
    _assert_loads_equal("jpeg.gltf", str(path), {})


def test_path_for_gltf_model():
    from transmission_renderer_tpu.scene.gltf import path_for_gltf_model

    assert pgltf.path_for_gltf_model("Sponza") == path_for_gltf_model("Sponza")
