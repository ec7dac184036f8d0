"""PBR layer: BRDF, lights, clustering, tonemap, volume attenuation
(counterpart of ``transmission_renderer_tpu/pbr``, with its names)."""

from transmission_renderer_tpu_torch.pbr.brdf import (  # noqa: F401
    BrdfResult,
    MaterialParams,
    apply_ior_to_roughness,
    apply_volume_attenuation,
    basic_brdf,
    combined_f0,
    combined_f90,
    d_ggx,
    fresnel_schlick,
    ibl_volume_refraction,
    ior_to_dielectric_f0,
    light_direction_and_attenuation,
    material_invariants,
    perceptual_to_actual_roughness,
    refract,
    transmission_btdf,
    v_smith_ggx_correlated,
)
from transmission_renderer_tpu_torch.pbr.clustering import (  # noqa: F401
    ClusterCoefficients,
    cluster_aabb_distance_sq,
    cluster_coefficients,
    cull_spotlight,
    get_depth_slice,
    linear_depth,
    slice_to_depth,
)
from transmission_renderer_tpu_torch.pbr.lights import (  # noqa: F401
    Lights,
    pack_lights,
    point_light,
    spot_light,
    spotlight_factor,
)
from transmission_renderer_tpu_torch.pbr.tonemap import (  # noqa: F401
    BakedLottesParams,
    LottesParams,
    bake_lottes_params,
    lottes_tonemap,
    lottes_tonemap_planes,
)
