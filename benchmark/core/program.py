"""The system under test: ``transmission_renderer_tpu_torch`` driven as its
command line's ``--frames`` loop drives it.

Each frame: the rig's update toward the viewer's target, the last
instance turned by 1/60 rad about +y (``--rotate-model``, from the second
frame on), the frame's uniforms, then ``render_frame`` with its
diagnostics. The image stays on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from transmission_renderer_tpu_torch.config import RenderConfig
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
from transmission_renderer_tpu_torch.scene.builder import SceneBuilder
from transmission_renderer_tpu_torch.scene.camera import CameraRig
from transmission_renderer_tpu_torch.scene.types import quat_from_rotation_y, quat_mul


def render_config(cfg: dict, **overrides) -> RenderConfig:
    r = dict(cfg["render"])
    for k, v in r.items():
        if isinstance(v, list):
            r[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
    r.update(overrides)
    return RenderConfig(**r)


def build_scene(arrays, device, with_bvh: bool):
    """The scene arrays through the port's SceneBuilder -> (scene, draw
    list, flags, bvh or None)."""
    b = SceneBuilder()
    for rgba, srgb in arrays.textures:
        b.add_texture(rgba, srgb)
    for m in arrays.materials:
        b.add_material(**m)
    for p in arrays.primitives:
        b.add_primitive(p.positions, p.normals, p.uvs, p.indices, bucket=p.bucket)
    for i in arrays.instances:
        b.add_instance(i.primitive, i.material, translation=i.translation, scale=i.scale,
                       rotation=i.rotation)
    scene, dl, flags = b.finish_bundle(device=device)
    bvh = b.build_rt_bvh(device=device) if with_bvh else None
    return scene, dl, flags, bvh


def make_lights(cfg: dict, device):
    return pack_lights([point_light(li["position"], li["colour"], li["intensity"])
                        for li in cfg["lights"]], device=device)


class Viewer:
    """One viewer's frames over a scene, from frame 0 of the path."""

    def __init__(self, cfg: dict, path, scene, dl, flags, lights, config: RenderConfig,
                 bvh, device):
        cam = cfg["camera"]
        self.rig = CameraRig()
        self.rig.camera.position = np.array(cam["position"], np.float32)
        self.rig.camera.yaw = cam["yaw"]
        self.rig.camera.pitch = cam["pitch"]
        self.rig.target_position = np.array(cam["position"], np.float32)
        self.rig.target_pitch = cam["pitch"]
        self.rig.target_yaw = cam["yaw"]
        self.rig.sun_pitch = cam["sun_pitch"]
        self.rig.sun_yaw = cam["sun_yaw"]
        self.cfg, self.path = cfg, path
        self.scene, self.dl, self.flags, self.lights = scene, dl, flags, lights
        self.config, self.bvh, self.device = config, bvh, device
        self.delta = torch.from_numpy(quat_from_rotation_y(path.dt)).to(device)
        self.frame = 0

    def step(self):
        """The host work before the call: the rig's update, the model's
        turn and the frame's uniforms -> FrameParams."""
        k = self.frame
        self.rig.target_yaw = self.cfg["camera"]["yaw"] + self.path.target_yaw(k)
        self.rig.update(self.path.dt)
        if self.path.rotate_model and k > 0:
            rot = self.scene.inst_transform.rotation.clone()
            rot[-1] = quat_mul(self.delta, rot[-1])
            self.scene = self.scene._replace(
                inst_transform=self.scene.inst_transform._replace(rotation=rot))
        cam = self.rig.camera
        return make_frame_params(self.config, cam.view_matrix(), cam.position,
                                 self.rig.sun_dir(), device=self.device)

    def render(self, params):
        """The entry the window drives -> (image, diagnostics)."""
        out = render_frame(self.scene, self.dl, params, self.lights, self.config,
                           flags=self.flags, bvh=self.bvh, return_diagnostics=True)
        self.frame += 1
        return out
