"""BRDF / BTDF library (the reference's port of the ``glam-pbr`` crate).

Counterpart of ``transmission_renderer_tpu/pbr/brdf.py``: MaterialParams,
BrdfResult, light_direction_and_attenuation, the roughness / F0 / F90
helpers, material_invariants, basic_brdf, transmission_btdf, refract,
get_volume_transmission_ray, apply_volume_attenuation and
ibl_volume_refraction. The visibility-buffer frame's shading
(render/shading.py's tensor path) calls them; the fused shade kernel
(render/shade_kernel.py) carries its own per-plane copies.

Functions are elementwise over leading batch dimensions: vectors are
[..., 3], scalars [...]. Shading dot products clamp below at float32
epsilon and not above (glam-pbr lib.rs:92-99).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# f32::EPSILON — shading dot products clamp to this (glam-pbr lib.rs:95)
F32_EPSILON = 1.1920929e-07
_PI = 3.14159265358979323846
_FRAC_1_PI = 1.0 / _PI


class MaterialParams(NamedTuple):
    """Per-shading-point material (glam-pbr lib.rs:171-179)."""

    diffuse_colour: torch.Tensor  # [..., 3]
    metallic: torch.Tensor  # [...]
    perceptual_roughness: torch.Tensor  # [...]
    index_of_refraction: torch.Tensor  # [...]
    specular_colour: torch.Tensor  # [..., 3]
    specular_factor: torch.Tensor  # [...]


class BrdfResult(NamedTuple):
    """Split diffuse/specular result (glam-pbr lib.rs:437-452)."""

    diffuse: torch.Tensor  # [..., 3]
    specular: torch.Tensor  # [..., 3]

    def __add__(self, other: "BrdfResult") -> "BrdfResult":
        return BrdfResult(self.diffuse + other.diffuse, self.specular + other.specular)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing axis of 3 in index order."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Clamped shading dot product (glam-pbr lib.rs:92-99)."""
    return torch.clamp(_sum3(a * b), min=F32_EPSILON)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(_sum3(v * v))[..., None]


def light_direction_and_attenuation(fragment_position, light_position):
    """Inverse-square point-light falloff (glam-pbr lib.rs:12-23) ->
    (direction [..., 3], distance [...], attenuation [...])."""
    vector = light_position - fragment_position
    distance_sq = _sum3(vector * vector)
    distance = torch.sqrt(distance_sq)
    return vector / distance[..., None], distance, 1.0 / distance_sq


def perceptual_to_actual_roughness(perceptual: torch.Tensor) -> torch.Tensor:
    """r_actual = r_perceptual^2 (glam-pbr lib.rs:153-156)."""
    return perceptual * perceptual


def apply_ior_to_roughness(roughness: torch.Tensor, ior: torch.Tensor) -> torch.Tensor:
    """roughness * clamp(2 ior - 2, 0, 1) (glam-pbr lib.rs:144-161)."""
    return roughness * torch.clamp(ior * 2.0 - 2.0, 0.0, 1.0)


def ior_to_dielectric_f0(ior: torch.Tensor) -> torch.Tensor:
    """((ior - 1) / (ior + 1))^2 (glam-pbr lib.rs:192-196)."""
    root = (ior - 1.0) / (ior + 1.0)
    return root * root


def d_ggx(noh: torch.Tensor, actual_roughness: torch.Tensor) -> torch.Tensor:
    """GGX normal distribution (glam-pbr lib.rs:101-109), 0 at the
    alpha = 0, noh = 1 singularity."""
    a2 = actual_roughness * actual_roughness
    f = (noh * noh) * (a2 - 1.0) + 1.0
    return torch.where(f * f > 0.0, a2 / (_PI * f * f), 0.0)


def v_smith_ggx_correlated(nov, nol, actual_roughness) -> torch.Tensor:
    """Height-correlated Smith visibility (glam-pbr lib.rs:114-133)."""
    a2 = actual_roughness * actual_roughness
    ggx_v = nol * torch.sqrt(nov * nov * (1.0 - a2) + a2)
    ggx_l = nov * torch.sqrt(nol * nol * (1.0 - a2) + a2)
    ggx = ggx_v + ggx_l
    return torch.where(ggx > 0.0, 0.5 / ggx, 0.0)


def fresnel_schlick(voh, f0, f90) -> torch.Tensor:
    """Schlick Fresnel with explicit f0/f90 (glam-pbr lib.rs:137-139)."""
    return f0 + (f90 - f0) * (1.0 - voh[..., None]) ** 5.0


def combined_f0(material: MaterialParams) -> torch.Tensor:
    """KHR_materials_specular combined F0 (glam-pbr lib.rs:425-430)."""
    dielectric = (ior_to_dielectric_f0(material.index_of_refraction)[..., None]
                  * material.specular_colour * material.specular_factor[..., None])
    return dielectric + (material.diffuse_colour - dielectric) * material.metallic[..., None]


def combined_f90(material: MaterialParams) -> torch.Tensor:
    """Combined F90 (glam-pbr lib.rs:432-435)."""
    dielectric = material.specular_factor[..., None].expand(material.diffuse_colour.shape)
    return dielectric + (1.0 - dielectric) * material.metallic[..., None]


class MaterialInvariants(NamedTuple):
    """Light-independent terms of basic_brdf / transmission_btdf,
    evaluated once per pixel (the same expressions, the same bits)."""

    actual_roughness: torch.Tensor  # [...]
    c_diff: torch.Tensor  # [..., 3]
    f0: torch.Tensor  # [..., 3]
    f90: torch.Tensor  # [..., 3]


def material_invariants(material: MaterialParams) -> MaterialInvariants:
    return MaterialInvariants(
        actual_roughness=perceptual_to_actual_roughness(material.perceptual_roughness),
        c_diff=material.diffuse_colour * (1.0 - material.metallic[..., None]),
        f0=combined_f0(material),
        f90=combined_f90(material),
    )


def basic_brdf(normal, light, light_intensity, view, material: MaterialParams,
               inv: MaterialInvariants | None = None) -> BrdfResult:
    """Lambert-with-Fresnel diffuse + GGX specular (glam-pbr
    lib.rs:377-423); ``light`` and ``view`` are unit vectors away from
    the surface."""
    if inv is None:
        inv = material_invariants(material)
    halfway = _normalize(view + light)
    noh = _dot(normal, halfway)
    nov = _dot(normal, view)
    nol = _dot(normal, light)
    voh = _dot(view, halfway)
    fresnel = fresnel_schlick(voh, inv.f0, inv.f90)
    radiance = light_intensity * nol[..., None]
    # (1 - max_element(F)) / pi * c_diff (glam-pbr lib.rs:356-360)
    fmax = torch.amax(fresnel, dim=-1, keepdim=True)
    diffuse = radiance * ((1.0 - fmax) * _FRAC_1_PI * inv.c_diff)
    dv = d_ggx(noh, inv.actual_roughness) * v_smith_ggx_correlated(
        nov, nol, inv.actual_roughness)
    specular = radiance * dv[..., None] * fresnel
    return BrdfResult(diffuse=diffuse, specular=specular)


def transmission_btdf(material: MaterialParams, normal, view, light,
                      inv: MaterialInvariants | None = None) -> torch.Tensor:
    """Per-light rough transmission lobe (glam-pbr lib.rs:200-233)."""
    if inv is None:
        inv = material_invariants(material)
    rough = apply_ior_to_roughness(inv.actual_roughness, material.index_of_refraction)
    l_dot_n = _sum3((-light) * normal)[..., None]
    light_mirrored = _normalize(light + 2.0 * normal * l_dot_n)
    halfway = _normalize(view + light_mirrored)
    noh = _dot(normal, halfway)
    voh = _dot(view, halfway)
    nov = _dot(normal, view)
    nol_mirrored = _dot(normal, light_mirrored)
    dv = d_ggx(noh, rough) * v_smith_ggx_correlated(nov, nol_mirrored, rough)
    fresnel = fresnel_schlick(voh, inv.f0, inv.f90)
    return (1.0 - fresnel) * dv[..., None] * material.diffuse_colour


def refract(incident, normal, ior) -> torch.Tensor:
    """GLSL refract with eta = 1/ior (glam-pbr lib.rs:248-256); no
    total-internal-reflection guard, as the reference."""
    eta = 1.0 / ior
    n_dot_i = _sum3(normal * incident)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    return eta[..., None] * incident - (eta * n_dot_i + torch.sqrt(k))[..., None] * normal


def get_volume_transmission_ray(normal, view, thickness, ior, model_scale):
    """Refracted exit ray scaled by thickness (glam-pbr lib.rs:258-268)
    -> (ray [..., 3], length [...])."""
    refraction = refract(-view, normal, ior)
    length = thickness * model_scale
    return _normalize(refraction) * length[..., None], length


def apply_volume_attenuation(
    transmitted_light: torch.Tensor,  # [..., 3]
    transmission_distance: torch.Tensor,  # [...]
    attenuation_distance: torch.Tensor,  # [...]
    attenuation_colour: torch.Tensor,  # [..., 3]
) -> torch.Tensor:
    """Beer's-law attenuation (glam-pbr/src/lib.rs:275-290);
    ``attenuation_distance == inf`` means no attenuation."""
    coefficient = -torch.log(attenuation_colour) / attenuation_distance[..., None]
    transmittance = torch.exp(-coefficient * transmission_distance[..., None])
    no_attenuation = torch.isinf(attenuation_distance)[..., None]
    return torch.where(
        no_attenuation, transmitted_light, transmittance * transmitted_light
    )


def ibl_volume_refraction(
    material: MaterialParams,
    framebuffer_size_x: float,
    normal: torch.Tensor,  # [..., 3]
    view: torch.Tensor,  # [..., 3]
    proj_view_matrix: torch.Tensor,  # [4, 4]: clip = M @ pos
    position: torch.Tensor,  # [..., 3]
    thickness: torch.Tensor,  # [...]
    model_scale: torch.Tensor,  # [...]
    attenuation_distance: torch.Tensor,  # [...]
    attenuation_colour: torch.Tensor,  # [..., 3]
    framebuffer_sampler: Callable,  # (uv [..., 2], lod [...]) -> [..., 3]
    ggx_lut_sampler: Callable,  # (nov [...], perceptual roughness [...]) -> [..., 2]
) -> torch.Tensor:
    """Once-per-pixel volume refraction (glam-pbr lib.rs:292-354): walk
    the refracted view ray through the volume, project its exit point,
    fetch the opaque framebuffer there at lod log2(fb_width) * roughness
    (after ior), attenuate, and weight by the split-sum specular."""
    ray, ray_length = get_volume_transmission_ray(
        normal, view, thickness, material.index_of_refraction, model_scale)
    exit_point = position + ray
    exit_h = torch.cat([exit_point, torch.ones_like(exit_point[..., :1])], dim=-1)
    device_coords = exit_h @ proj_view_matrix.T
    screen = device_coords[..., :2] / device_coords[..., 3:4]
    texture_coords = (screen + 1.0) / 2.0
    log2_w = torch.log2(torch.tensor(float(framebuffer_size_x), device=position.device))
    lod = log2_w * apply_ior_to_roughness(material.perceptual_roughness,
                                          material.index_of_refraction)
    transmitted = framebuffer_sampler(texture_coords, lod)
    attenuated = apply_volume_attenuation(transmitted, ray_length, attenuation_distance,
                                          attenuation_colour)
    # unclamped dot, as the reference (glam-pbr lib.rs:345)
    brdf = ggx_lut_sampler(_sum3(normal * view), material.perceptual_roughness)
    specular_colour = combined_f0(material) * brdf[..., 0:1] + combined_f90(material) * brdf[..., 1:2]
    return (1.0 - specular_colour) * attenuated * material.diffuse_colour
