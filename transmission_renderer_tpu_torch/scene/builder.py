"""SceneBuilder — host-side accumulation of geometry, instances, materials.

Counterpart of ``transmission_renderer_tpu/scene/builder.py`` (SceneBuilder,
classify_draw_bucket, finish, finish_bundle). Same staging lists and the
same freeze; ``finish`` / ``finish_bundle`` produce the port's tensors on
an explicit ``device``, with no JAX anywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from transmission_renderer_tpu_torch.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
)
from transmission_renderer_tpu_torch.scene.textures import (
    AtlasBuilder,
    texture_ref,
)
from transmission_renderer_tpu_torch.scene.types import (
    Scene,
    Similarity,
    default_material,
    pack_materials,
    quat_identity,
    to_device,
)


def classify_draw_bucket(alpha_mode: str, has_transmission: bool) -> int:
    """(alpha_mode x transmission) -> draw bucket (src/model_loading.rs:68-78)."""
    table = {
        ("OPAQUE", False): BUCKET_OPAQUE,
        ("MASK", False): BUCKET_ALPHA_CLIP,
        ("OPAQUE", True): BUCKET_TRANSMISSION,
        ("MASK", True): BUCKET_TRANSMISSION_ALPHA_CLIP,
    }
    return table.get((alpha_mode, has_transmission), BUCKET_OPAQUE)


class SceneBuilder:
    def __init__(self):
        self.positions: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []
        self.indices: list[np.ndarray] = []
        self.prim_sphere: list[np.ndarray] = []
        self.prim_bucket: list[int] = []
        self.prim_first_tri: list[int] = []
        self.prim_tri_count: list[int] = []
        self.inst_translation: list[np.ndarray] = []
        self.inst_scale: list[float] = []
        self.inst_rotation: list[np.ndarray] = []
        self.inst_primitive: list[int] = []
        self.inst_material: list[int] = []
        self.materials: list[dict] = []
        self.atlas = AtlasBuilder()
        self._num_vertices = 0
        self._num_indices = 0

    def add_primitive(self, positions, normals, uvs, indices, bucket: int,
                      uv_scaling=(1.0, 1.0)) -> int:
        positions = np.asarray(positions, np.float32)
        normals = np.asarray(normals, np.float32)
        if uvs is None:
            uvs = np.zeros((len(positions), 2), np.float32)
        else:
            uvs = np.asarray(uvs, np.float32) * np.asarray(uv_scaling, np.float32)
        indices = np.asarray(indices, np.uint32).reshape(-1, 3)

        prim_id = len(self.prim_bucket)
        self.indices.append(indices + self._num_vertices)
        self.positions.append(positions)
        self.normals.append(normals)
        self.uvs.append(uvs)

        # AABB -> bounding sphere (src/model_loading.rs:148-155)
        mn = positions.min(0)
        mx = positions.max(0)
        center = (mn + mx) / 2.0
        radius = np.linalg.norm(mx - mn) / 2.0
        self.prim_sphere.append(np.array([*center, radius], np.float32))
        self.prim_bucket.append(bucket)
        self.prim_first_tri.append(self._num_indices // 3)
        self.prim_tri_count.append(len(indices))

        self._num_vertices += len(positions)
        self._num_indices += indices.size
        return prim_id

    def add_instance(self, primitive_id: int, material_id: int,
                     translation=(0.0, 0.0, 0.0), scale: float = 1.0,
                     rotation=None) -> int:
        self.inst_translation.append(np.asarray(translation, np.float32))
        self.inst_scale.append(float(scale))
        self.inst_rotation.append(
            quat_identity() if rotation is None else np.asarray(rotation, np.float32)
        )
        self.inst_primitive.append(primitive_id)
        self.inst_material.append(material_id)
        return len(self.inst_primitive) - 1

    def add_material(self, **overrides) -> int:
        self.materials.append(default_material(**overrides))
        return len(self.materials) - 1

    def add_texture(self, rgba: np.ndarray, srgb: bool) -> int:
        return self.atlas.push_image(rgba, srgb)

    def add_texture_bundle(self, images) -> list[int]:
        bid = self.atlas.push_bundle(
            [im for im, _ in images], [bool(s) for _, s in images]
        )
        return [texture_ref(bid, k) for k in range(len(images))]

    def _draw_arrays(self):
        return (
            np.array(self.inst_primitive, np.int32),
            np.array(self.inst_material, np.int32),
            np.array(self.prim_first_tri, np.int32),
            np.array(self.prim_tri_count, np.int32),
            np.array(self.prim_bucket, np.int32),
            np.concatenate(self.indices).astype(np.int32).reshape(-1, 3),
        )

    def finish_bundle(self, device="cpu"):
        """(Scene, DrawList, SceneFlags) on ``device``; the draw list and
        the flags are derived from the host staging lists."""
        from transmission_renderer_tpu_torch.render.frame import (
            TEX_SLOT_NAMES,
            build_draw_list_from_numpy,
            scene_flags_from_arrays,
        )

        scene = self.finish(device)
        dl = build_draw_list_from_numpy(*self._draw_arrays(), device=device)
        mats = self.materials or [default_material()]
        flags = scene_flags_from_arrays(
            np.array(self.prim_bucket, np.int32),
            np.array(self.inst_primitive, np.int32),
            np.array(self.inst_material, np.int32),
            {n: np.array([m[n] for m in mats], np.int64)
             for n in TEX_SLOT_NAMES},
            np.array([m["roughness_factor"] for m in mats], np.float32),
            np.array([m["index_of_refraction"] for m in mats], np.float32),
            self.atlas.push_time_meta(),
        )
        return scene, dl, flags

    def finish(self, device="cpu") -> Scene:
        assert self.prim_bucket, "empty scene"
        texels, meta, srgb = self.atlas.finish()
        t = torch.from_numpy
        scene = Scene(
            positions=t(np.concatenate(self.positions)),
            normals=t(np.concatenate(self.normals)),
            uvs=t(np.concatenate(self.uvs)),
            indices=t(np.concatenate(self.indices).astype(np.int32)),
            prim_bounding_sphere=t(np.stack(self.prim_sphere)),
            prim_draw_bucket=t(np.array(self.prim_bucket, np.int32)),
            prim_first_tri=t(np.array(self.prim_first_tri, np.int32)),
            prim_tri_count=t(np.array(self.prim_tri_count, np.int32)),
            inst_transform=Similarity(
                translation=t(np.stack(self.inst_translation)),
                scale=t(np.array(self.inst_scale, np.float32)),
                rotation=t(np.stack(self.inst_rotation)),
            ),
            inst_primitive_id=t(np.array(self.inst_primitive, np.int32)),
            inst_material_id=t(np.array(self.inst_material, np.int32)),
            materials=pack_materials(self.materials),
            atlas_texels=texels,
            atlas_meta=meta,
            atlas_srgb=srgb,
        )
        return to_device(scene, device)
