"""The plain reference frame: what a 1080p frame of the configuration
shows, worked out from the scene arrays, the camera, the lights and the
frame's instance turns alone.

Passes: the vertex stage; the opaque z-buffer (opaque triangles, then
alpha-clip triangles whose fragments pass the alpha test, strictly in
front of it); the transmissive z-buffer seeded with that depth (and its
alpha-clip class likewise); clustered light lists; optional ray-traced
shadow factors; the opaque shade; the opaque framebuffer's pyramid; the
transmission shade over it; the tonemap. Imports nothing of the program
under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import geometry, raster, shading
from benchmark.scenes.meshes import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
)

# the renderer's settings the reference reads (the rest shape only the
# program's own work, not the image)
FRAME_KEYS = ("width", "height", "z_near", "z_far", "vertical_fov", "num_clusters_x",
              "num_clusters_y", "num_depth_slices")


@dataclasses.dataclass
class Prepared:
    """What the reference derives once per scene."""

    geo: geometry.Geometry
    textures: list
    mats: shading.Materials
    lights: dict
    lut: torch.Tensor
    proj: np.ndarray
    clip_tris: bool


def prepare(scene, cfg: dict, light_list: list, device) -> Prepared:
    textures = [shading.make_texture(rgba, srgb, device) for rgba, srgb in scene.textures]
    lights = dict(
        position=torch.tensor(np.array([li["position"] for li in light_list], np.float32),
                              device=device),
        colour=torch.tensor(np.array([np.asarray(li["colour"], np.float32) * np.float32(
            li["intensity"]) for li in light_list], np.float32), device=device),
        falloff_sq=torch.tensor(np.array([np.float32(li["intensity"] / 0.05)
                                          for li in light_list], np.float32), device=device),
    )
    geo = geometry.expand(scene, device)
    proj = geometry.perspective_reversed(cfg["width"], cfg["height"], cfg["vertical_fov"],
                                         cfg["z_near"], cfg["z_far"])
    clip = (geo.tri_bucket == BUCKET_ALPHA_CLIP) | (geo.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
    return Prepared(geo, textures, shading.make_materials(scene.materials, device), lights,
                    torch.from_numpy(shading.ggx_table()).to(device), proj,
                    bool(clip.any()))


def _pass(prep: Prepared, records, valid, bbox, buckets, seed, w, h):
    """One pass's winners: the z-buffer of the pass's plain bucket, then
    its alpha-clip bucket over that (strictly in front) -> (valid, tri,
    depth) per pixel."""
    geo = prep.geo
    plain, clip_b = buckets
    tris = torch.nonzero(valid & (geo.tri_bucket == plain))[:, 0]
    v, tri, depth = raster.winners(raster.zbuffer(records, bbox, tris, w, h, seed))
    if prep.clip_tris:
        ctris = torch.nonzero(valid & (geo.tri_bucket == clip_b))[:, 0]

        def keep(t, px, py, e):
            uv, dx, dy = raster.interpolate(records[t], geo.uvs[geo.tri_vtx[t]], e, w, h, True)
            mat = geo.tri_material[t]
            alpha = shading.diffuse_sample(prep.mats, prep.textures, mat, uv, dx, dy)[..., 3]
            return alpha >= prep.mats.cutoff[mat]

        base = torch.where(v, depth, seed if seed is not None else torch.zeros_like(depth))
        cv, ctri, cdepth = raster.winners(raster.zbuffer(records, bbox, ctris, w, h, base, keep))
        v, tri, depth = v | cv, torch.where(cv, ctri, tri), torch.where(cv, cdepth, depth)
    return v, tri, depth


def _gbuffer(prep: Prepared, records, world, normal, tri, pix, w, h):
    """Interpolated position, normal, uv, uv derivatives, material and
    instance scale of the winners ``tri`` at pixels ``pix``."""
    geo = prep.geo
    px, py = pix % w, pix // w
    r = records[tri]
    e = raster.edge_values(r, *raster.pixel_ndc(px, py, w, h))
    tv = geo.tri_vtx[tri]
    pos, _, _ = raster.interpolate(r, world[tv], e, w, h, False)
    nrm, _, _ = raster.interpolate(r, normal[tv], e, w, h, False)
    uv, dx, dy = raster.interpolate(r, geo.uvs[tv], e, w, h, True)
    return dict(position=pos, normal=nrm, uv=uv, duv_dx=dx, duv_dy=dy,
                material=geo.tri_material[tri], scale=geo.scale[geo.tri_inst[tri]],
                px=px, py=py)


def _surface(prep: Prepared, g: dict):
    m = prep.mats
    mat = g["material"]
    diffuse = shading.diffuse_sample(m, prep.textures, mat, g["uv"], g["duv_dx"], g["duv_dy"])
    s = shading.Surface(diffuse[..., :3], m.metallic[mat], m.roughness[mat], m.ior[mat],
                        m.specular_colour[mat], m.specular[mat])
    return s, m.emissive[mat]


def render(prep: Prepared, cfg: dict, rig: geometry.Rig, rotation: torch.Tensor,
           shadows=None) -> torch.Tensor:
    """The frame's tonemapped linear image [H, W, 3]. ``shadows(world,
    tri_vtx, position, sun_dir, light_list_mask, light_positions)`` ->
    (sun factor [M], light factors [M, L]) gives ray-traced shadow
    factors (1 lit, 0 shadowed); None renders without shadows."""
    w, h = cfg["width"], cfg["height"]
    dev = rotation.device
    view_np = rig.view_matrix()
    view = torch.from_numpy(view_np).to(dev)
    proj_view = torch.from_numpy(np.ascontiguousarray(prep.proj @ view_np, np.float32)).to(dev)
    view_pos = torch.from_numpy(np.asarray(rig.position, np.float32)).to(dev)
    sun_dir = torch.from_numpy(rig.sun_dir()).to(dev)
    sun_intensity = torch.tensor([3.0, 3.0, 3.0], device=dev)
    geo = prep.geo

    world, normal, clip = geometry.vertex_stage(geo, rotation, proj_view)
    records, valid, bbox = raster.setup(clip, geo.tri_vtx,
                                        torch.ones_like(geo.tri_bucket, dtype=torch.bool), w, h)
    vo, tri_o, depth_o = _pass(prep, records, valid, bbox, (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
                               None, w, h)
    seed_t = torch.where(vo, depth_o, 0.0)
    vt, tri_t, depth_t = _pass(prep, records, valid, bbox,
                               (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP),
                               seed_t, w, h)
    clusters = shading.make_clusters(cfg, view, prep.lights["position"],
                                     prep.lights["falloff_sq"], np.linalg.inv(prep.proj))
    hdr = torch.zeros((3, h * w), dtype=torch.float32, device=dev)

    def shade(vmask, tri, depth, transmission, levels=None):
        pix = torch.nonzero(vmask)[:, 0]
        g = _gbuffer(prep, records, world, normal, tri[pix], pix, w, h)
        s, emission = _surface(prep, g)
        nrm = shading.normalize_safe(g["normal"])
        viewv = shading.normalize_safe(view_pos - g["position"])
        in_list = clusters.accept[shading.cluster_of(clusters, depth[pix], g["px"], g["py"]).long()]
        sun_f = light_f = None
        if shadows is not None:
            sun_f, light_f = shadows(world, geo.tri_vtx, g["position"], sun_dir, in_list,
                                     prep.lights["position"])
        diffuse, specular, trans = shading.lights_loop(
            s, nrm, viewv, g["position"], sun_dir, sun_intensity, prep.lights, in_list,
            sun_f, light_f, transmission)
        if not transmission:
            return pix, diffuse + specular + emission
        m = prep.mats
        mat = g["material"]
        trans = trans + shading.volume_refraction(
            s, w, nrm, viewv, proj_view, g["position"], m.thickness[mat], g["scale"],
            m.attenuation_distance[mat], m.attenuation_colour[mat], levels, prep.lut)
        tf = m.transmission[mat][..., None]
        return pix, (diffuse + (tf * trans - diffuse) * tf) + specular + emission

    pix, out = shade(vo, tri_o, depth_o, False)
    hdr[:, pix] = out.T
    if bool(vt.any()):
        levels = shading.pyramid(hdr.reshape(3, h, w))
        pix, out = shade(vt, tri_t, depth_t, True, levels)
        hdr[:, pix] = out.T
    return shading.tonemap(*hdr.reshape(3, h, w))
