"""The visibility-buffer branch's frame variants, against the JAX
package's frames at 128x72 (tests/variants_defs.py, CFG):

- ``quad_material_taps`` on the small dragon (the dense opaque shade's
  quad taps), and with ``bf16_light_math`` (the light loop's bf16 cores);
- ``half_res_refraction`` on the textured-roughness dragon: the dense
  transmission shade's half-res fetch over the whole pyramid (no level
  set) on the tensor path;
- ray-traced shadows on this branch: the opaque pass's rays in 8x16
  groups, the compacted transmission worklist's in its own order.

Tolerances: linear RMSE <= 1e-5 and every diagnostic equal; shadow factors
equal on every ray; bf16: the port's frame within a quarter of the
reference's own bf16 error of the reference's frame (that error measured
against the reference's frame without bf16), and the port's own bf16
error, in sRGB as
tests/test_goldens.py measures it, under the reference's bounds: 1e-2 on
the dragon, 2e-3 on the helmet.
"""

import dataclasses

import pytest
import torch

from variants_defs import (
    BF16_SHARE,
    VIS,
    FrameCache,
    check_diagnostics,
    check_factors,
    check_image,
    check_range,
    rmse,
    srgb,
)

torch.set_num_threads(1)

CONFIGS = {
    "exact": VIS,
    "quad": dataclasses.replace(VIS, quad_material_taps=True),
    "quad_bf16": dataclasses.replace(VIS, quad_material_taps=True, bf16_light_math=True),
    "bf16": dataclasses.replace(VIS, bf16_light_math=True),
    "half": dataclasses.replace(VIS, half_res_refraction=True),
    "rt": dataclasses.replace(VIS, ray_traced_shadows=True),
}


@pytest.fixture(scope="module")
def frames():
    return FrameCache(CONFIGS, rt_kinds=("dragon",))


def test_quad_frame_matches_reference(frames):
    pair = frames("dragon", "quad")
    check_image(pair)
    check_diagnostics(pair)
    assert rmse(pair["img"], frames("dragon", "exact", port_only=True)["img"]) > 1e-4


def test_quad_bf16_frame_matches_reference(frames):
    """The reference's own bf16 error is its quad_bf16 frame against its
    quad frame (the same config without bf16)."""
    pair = frames("dragon", "quad_bf16")
    check_range(pair)
    own, err = rmse(pair["ref"], frames("dragon", "quad")["ref"]), rmse(pair["img"], pair["ref"])
    print(f"port vs reference {err:.3g}, the reference's bf16 error {own:.3g}")
    assert err <= BF16_SHARE * own
    check_diagnostics(pair)


def test_half_res_textured_glass_frame_matches_reference(frames):
    pair = frames("textured_glass", "half")
    check_image(pair)
    check_diagnostics(pair)
    assert rmse(pair["img"], frames("textured_glass", "exact", port_only=True)["img"]) > 1e-4
    assert frames.scene("textured_glass").port[2].transmission_ior_roughness is None


@pytest.mark.parametrize("kind,bound", [("dragon", 1e-2), ("helmet", 2e-3)])
def test_bf16_error_under_reference_bounds(frames, kind, bound):
    """tests/test_goldens.py::test_bf16_light_math_error_bound on the
    port's frames (sRGB RMSE against the exact frame)."""
    exact = frames(kind, "exact", port_only=True)["img"]
    bf16 = frames(kind, "bf16", port_only=True)["img"]
    err = rmse(srgb(bf16), srgb(exact))
    print(f"{kind}: bf16 vs exact sRGB RMSE {err:.3g}")
    assert 0.0 < err < bound


def test_rt_frame_matches_reference(frames):
    pair = frames("dragon", "rt")
    check_image(pair)
    check_diagnostics(pair)
    check_factors(pair, ("2d", None))
    assert int(pair["diag"].transmission_blocks) > 0
    # the visibility raster, the tensor shade: no G-buffer raster or shade kernel
    assert not pair["calls"]["raster_gbuf"] and not pair["calls"]["shade"]
