"""The glass dragon over Sponza, in the order the upstream viewer loads a
model: the base scene first (the Sponza-foliage analogue of
``stress.py``), then the model (the DragonAttenuation analogue's glass
blob of ``dragon.py``: transmission and volume attenuation), so that the
blob is the last instance, the one ``--rotate-model`` turns.

Both parts are built from fixed seeds of the configuration
(``base_seed``, ``model_seed``), so the run's seed changes only the
viewer's path and never the scene."""

from __future__ import annotations

import numpy as np

from benchmark.scenes import stress
from benchmark.scenes.meshes import BUCKET_TRANSMISSION, SceneArrays, displaced_sphere


def build(p: dict, rng: np.random.Generator) -> SceneArrays:
    del rng  # the scene is fixed; the seed moves the viewer alone
    s = stress.build(p["base"], np.random.default_rng(p["base_seed"]))
    m = p["model"]
    glass = m["glass"]
    glass_mat = s.add_material(
        diffuse_factor=(1.0, 1.0, 1.0, 1.0), roughness_factor=glass["roughness"],
        metallic_factor=0.0, transmission_factor=1.0, thickness_factor=glass["thickness"],
        attenuation_distance=glass["attenuation_distance"],
        attenuation_colour=tuple(glass["attenuation_colour"]),
        index_of_refraction=glass["ior"])
    blob = s.add_primitive(*displaced_sphere(m["stacks"], m["sectors"],
                                             np.random.default_rng(p["model_seed"]), m["amp"]),
                           bucket=BUCKET_TRANSMISSION)
    s.add_instance(blob, glass_mat, translation=tuple(m["translation"]), scale=m["scale"])
    return s
