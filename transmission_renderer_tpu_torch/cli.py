"""The port's command line, on the card by default.

Counterpart of ``transmission_renderer_tpu/cli.py``: the same flags, with
the same names and defaults (``build_parser``), the same scenes, lights,
camera rig, frame loop, PNG names and interactive keys. Frames render
through the port's ``render_frame`` (the G-buffer kernel branch on the
card, the visibility-buffer branch with ``--cpu``), the AS-debug view
through ``render_as_debug_frame`` (the closest-hit kernel), and PNGs are
written by ``utils/png.py``.

    python -m transmission_renderer_tpu_torch.cli --procedural dragon --roughness-override 0.25
    python -m transmission_renderer_tpu_torch.cli --procedural dragon --as-debug -o as_debug.png
    python -m transmission_renderer_tpu_torch.cli model.glb --external-model --no-sponza --check-nan
    python -m transmission_renderer_tpu_torch.cli --cpu --procedural test --width 128 --height 72
    python -m transmission_renderer_tpu_torch.cli --cpu --debug-checks --procedural stress --width 128 --height 72

It runs on the card unless ``--cpu`` is given, and without a card it
exits non-zero rather than carry on on the CPU. The quality flags
``--half-res-refraction``, ``--quad-taps`` and ``--bf16-lights`` render
as the reference's do (through the tensor shade, where its gate sends
them). ``--debug-checks`` renders through render/checks.py's
checked_frame_fn (the visibility-buffer branch with the index checks
on), and exits 2 with the reference's message beside ``--devices`` > 1,
``--as-debug`` or ``--ray-tracing``. A mode the port does not have yet
(``--devices`` > 1, a JPEG image in a glTF, a frame branch
``render_frame`` refuses) prints the NotImplementedError message, which
says why, and exits with code 2, as the reference's CLI does for the
combinations it rejects.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    """The reference's parser (cli.py:22-148): every flag, name and
    default."""
    p = argparse.ArgumentParser(
        prog="transmission-renderer-tpu-torch",
        description="PyTorch + CUDA forward-plus glTF PBR renderer "
        "(KHR_materials_transmission / KHR_materials_volume).",
    )
    p.add_argument("gltf_sample_model_name", nargs="?", default=None,
                   help="Name of the model inside the glTF-Sample-Models directory")
    p.add_argument("--scale", "-s", type=float, default=1.0,
                   help="Scale factor applied to the model")
    p.add_argument("--roughness-override", type=float, default=None,
                   help="Override the model's roughness factor")
    p.add_argument("--external-model", action="store_true",
                   help="Treat the positional arg as a full glTF/GLB path")
    p.add_argument("--ray-tracing", action="store_true",
                   help="Enable ray-traced shadows (BVH path)")
    p.add_argument("--spotlights", action="store_true",
                   help="Add the two animated test spotlights")
    p.add_argument("--rotate-model", action="store_true",
                   help="Rotate the last instance each frame")
    p.add_argument("--log-leaks", action="store_true",
                   help="Accepted for parity; tensors are freed by PyTorch")
    p.add_argument("--procedural",
                   choices=["test", "helmet", "dragon", "attenuation", "stress", "bindless"],
                   default=None, help="Render a built-in procedural scene")
    p.add_argument("--detail", type=float, default=1.0,
                   help="Geometry detail multiplier for procedural scenes "
                   "(1.0 = benchmark detail; use ~0.2 for quick CPU runs)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=1,
                   help="Number of frames along the orbit camera path")
    p.add_argument("--output", "-o", default="frame.png",
                   help="Output PNG (multi-frame: suffixed _NNN)")
    p.add_argument("--no-sponza", action="store_true",
                   help="Skip the Sponza base scene the reference always loads")
    p.add_argument("--cluster-wireframe", type=int, nargs="?", const=5, default=None,
                   metavar="SLICE",
                   help="Overlay cluster AABB wireframes (shader/src/lib.rs:801-839). "
                   "Optional depth-slice index (default 5); -1 draws all 16 slices")
    p.add_argument("--debug-clusters", action="store_true",
                   help="Cluster false-colour debug view (the F-key toggle)")
    p.add_argument("--as-debug", action="store_true",
                   help="Render the ray-cast acceleration-structure debug view "
                   "(the T-key toggle; implies --ray-tracing)")
    p.add_argument("--cam-pos", type=float, nargs=3, default=[0.0, 2.2, 1.5],
                   metavar=("X", "Y", "Z"), help="Camera position")
    p.add_argument("--cam-pitch", type=float, default=-0.25, help="Camera pitch (radians)")
    p.add_argument("--cam-yaw", type=float, default=0.0, help="Camera yaw (radians)")
    p.add_argument("--sun-pitch", type=float, default=1.1,
                   help="Sun pitch (reference default 1.1, src/main.rs:531)")
    p.add_argument("--sun-yaw", type=float, default=4.8,
                   help="Sun yaw (reference default 4.8)")
    p.add_argument("--devices", type=int, default=1,
                   help="Shard the framebuffer over N devices (row bands; not ported)")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (the kernels' plain PyTorch versions)")
    p.add_argument("--interactive", action="store_true",
                   help="Headless interactive loop: read WASD/QE (move), IJKL (look), "
                   "u/o/p/; (sun), <enter> renders a frame, 'x' quits")
    p.add_argument("--half-res-refraction", action="store_true",
                   help="Half-res framebuffer fetch in the transmission pass (quality flag)")
    p.add_argument("--quad-taps", action="store_true",
                   help="Share one material-texture tap per 2x2 pixel quad (quality flag)")
    p.add_argument("--nol-shadow-gate", action="store_true",
                   help="skip shadow rays where N.L <= 0 (near-lossless, max delta "
                   "~1e-3; normal-map-free scenes only)")
    p.add_argument("--bf16-lights", action="store_true",
                   help="Evaluate the per-light BRDF/BTDF cores in bfloat16 (quality flag)")
    p.add_argument("--half-res-shadows", action="store_true",
                   help="Trace --ray-tracing shadow rays on a half-res grid and upsample "
                   "the visibility factors")
    p.add_argument("--check-nan", action="store_true",
                   help="Validate each frame: NaN/Inf scan + capacity-overflow "
                   "diagnostics (bins, big-triangle list, block worklists, clip peeling)")
    p.add_argument("--debug-checks", action="store_true",
                   help="Out-of-bounds index checks of the frame (not ported)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="Capture a torch.profiler Chrome trace of the frame loop into "
                   "DIR/trace.json; per-pass ranges carry the reference's pass names")
    return p


def _builder(args):
    """The scene's SceneBuilder (procedural, or Sponza + a glTF model);
    raises FileNotFoundError for a missing model."""
    from transmission_renderer_tpu_torch import models

    if args.procedural:
        d = args.detail
        return {
            "test": models.build_test_scene,
            "helmet": lambda: models.build_opaque_scene(
                stacks=max(int(64 * d), 8), sectors=max(int(128 * d), 16)),
            "dragon": lambda: models.build_dragon_scene(
                stacks=max(int(180 * d), 8), sectors=max(int(360 * d), 16),
                roughness_override=args.roughness_override),
            "attenuation": models.build_attenuation_scene,
            "stress": lambda: models.build_stress_scene(grid=max(int(5 * d), 2)),
            "bindless": models.build_bindless_scene,
        }[args.procedural]()
    from transmission_renderer_tpu_torch.scene.builder import SceneBuilder
    from transmission_renderer_tpu_torch.scene.gltf import load_gltf, path_for_gltf_model

    path = (args.gltf_sample_model_name if args.external_model
            else path_for_gltf_model(args.gltf_sample_model_name))
    builder = SceneBuilder()
    if not args.no_sponza:
        # the reference always loads Sponza first (src/main.rs:342-351)
        try:
            load_gltf(path_for_gltf_model("Sponza"), builder)
        except FileNotFoundError:
            print("note: Sponza not found, skipping base scene", file=sys.stderr)
    load_gltf(path, builder, base_scale=args.scale, roughness_override=args.roughness_override)
    return builder


def _refuse_unported(args) -> None:
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: row-band sharding: ROADMAP queue 1, item 8 "
            "(row-band sharding)")


def main(argv=None, frames_out: list | None = None) -> int:
    """Run the CLI; ``frames_out``, when given, receives each written
    frame's linear image ([H, W, 3] float32 NumPy) in order."""
    args = build_parser().parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device; the renderer runs on the card (pass --cpu to run "
              "on the CPU)", file=sys.stderr)
        return 1
    try:
        return _run(args, torch.device("cpu" if args.cpu else "cuda"), frames_out)
    except NotImplementedError as e:
        print(f"error: not ported yet: {e}", file=sys.stderr)
        return 2


def _run(args, dev, frames_out) -> int:
    import torch

    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.models import bindless_lights
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light, spot_light
    from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
    from transmission_renderer_tpu_torch.scene.camera import CameraRig
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
    from transmission_renderer_tpu_torch.utils.png import write_png

    if args.debug_checks and (args.devices > 1 or args.as_debug or args.ray_tracing):
        print("error: --debug-checks supports the single-device "
              "non-RT frame path only", file=sys.stderr)
        return 2
    _refuse_unported(args)
    config = RenderConfig(
        width=args.width,
        height=args.height,
        ray_traced_shadows=args.ray_tracing or args.as_debug,
        spotlights=args.spotlights,
        rotate_model=args.rotate_model,
        debug_clusters=args.debug_clusters,
        half_res_refraction=args.half_res_refraction,
        quad_material_taps=args.quad_taps,
        half_res_shadow_rays=args.half_res_shadows,
        nol_shadow_gate=args.nol_shadow_gate,
        bf16_light_math=args.bf16_lights,
        # the checks run on the visibility-buffer branch (render/checks.py)
        use_pallas_raster=False if args.debug_checks else None,
    )

    # ---- scene -------------------------------------------------------------
    if not args.procedural and not args.gltf_sample_model_name:
        print("error: give a model name or --procedural <scene>", file=sys.stderr)
        return 2
    try:
        builder = _builder(args)
    except FileNotFoundError as e:
        print(f"error: model not found: {e.filename}", file=sys.stderr)
        return 2
    scene, dl, flags = builder.finish_bundle(device=dev)
    print(f"scene: {scene.num_triangles} tris, {scene.num_instances} instances, "
          f"{scene.materials.num} materials; flags={flags}")

    # ---- lights (src/main.rs:450-472) -------------------------------------
    if args.procedural == "bindless":
        light_list = bindless_lights()
    else:
        light_list = [
            point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
            point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
        ]
    if args.spotlights:
        light_list += [
            spot_light([0.0, 4.0, 0.0], [1.0, 1.0, 0.5], 50.0, [0.0, 0.0, 1.0], 0.7, 0.8),
            spot_light([0.0, 4.0, 0.0], [1.0, 1.0, 0.5], 50.0, [0.0, 0.0, -1.0], 0.7, 0.8),
        ]
    lights = pack_lights(light_list, device=dev)

    rig = CameraRig()
    rig.target_position = np.array(args.cam_pos, np.float32)
    rig.target_pitch = args.cam_pitch
    rig.target_yaw = args.cam_yaw
    rig.camera.position = rig.target_position.copy()
    rig.camera.pitch = rig.target_pitch
    rig.camera.yaw = rig.target_yaw
    rig.sun_pitch = args.sun_pitch
    rig.sun_yaw = args.sun_yaw

    bvh = None
    if config.ray_traced_shadows:
        print("building BVH...", file=sys.stderr)
        bvh = builder.build_rt_bvh(device=dev)

    if args.as_debug:
        from transmission_renderer_tpu_torch.render.raytrace import render_as_debug_frame

        def render(s, d, p, lt):
            return render_as_debug_frame(s, d, p, lt, config, bvh)
    elif args.check_nan:
        # validation mode also reads the FrameDiagnostics and warns on any
        # capacity overflow
        def render(s, d, p, lt):
            ldr, diag = render_frame(s, d, p, lt, config, flags, bvh=bvh,
                                     return_diagnostics=True)
            if diag.overflowed():
                print(f"VALIDATION: capacity overflow! {diag}", file=sys.stderr)
            return ldr
    else:
        def render(s, d, p, lt):
            return render_frame(s, d, p, lt, config, flags, bvh=bvh)

    if args.debug_checks:
        from transmission_renderer_tpu_torch.render.checks import checked_frame_fn

        render = checked_frame_fn(config=config, flags=flags)

    def check_frame(ldr):
        if args.check_nan:
            bad = int(np.isnan(ldr).sum() + np.isinf(ldr).sum())
            if bad:
                print(f"VALIDATION: {bad} non-finite pixels!", file=sys.stderr)

    apply_overlays = _overlay_fn(args, config, dev)

    def frame_path(frame: int, multi: bool) -> str:
        if not multi:
            return args.output
        root, ext = os.path.splitext(args.output)
        return f"{root}_{frame:03d}{ext or '.png'}"

    def draw(s, lt, out):
        """Render, read back (which waits for the card), check, write."""
        params = make_frame_params(config, rig.camera.view_matrix(), rig.camera.position,
                                   rig.sun_dir(), device=dev)
        t0 = time.time()
        ldr = apply_overlays(render(s, dl, params, lt)).cpu().numpy()
        check_frame(ldr)
        dt = time.time() - t0
        write_png(out, linear_to_srgb(ldr))
        if frames_out is not None:
            frames_out.append(ldr)
        return dt

    with contextlib.ExitStack() as stack:
        if args.profile:
            from transmission_renderer_tpu_torch.utils.profiling import trace

            # registered first, so it runs after the trace is written
            stack.callback(print, f"profiler trace written to {args.profile}",
                           file=sys.stderr)
            stack.enter_context(trace(args.profile))

        if args.interactive:
            # headless analogue of the reference's winit loop (src/main.rs:923-1456):
            # keys move the rig and the sun; each <enter> renders to --output
            print("interactive: w/a/s/d/q/e move, i/j/k/l look, u/o/p/; sun, <enter> render, "
                  "x quit", file=sys.stderr)
            move = {"w": (1, 0, 0), "s": (-1, 0, 0), "a": (0, -1, 0), "d": (0, 1, 0),
                    "q": (0, 0, -1), "e": (0, 0, 1)}
            look = {"i": (0, 0.1), "k": (0, -0.1), "j": (0.1, 0), "l": (-0.1, 0)}
            frame = 0
            for line in sys.stdin:
                for ch in line.strip():
                    if ch == "x":
                        return 0
                    if ch in move:
                        rig.move_relative(*move[ch], speed=0.5)
                    elif ch in look:
                        rig.rotate(*look[ch])
                    elif ch in "uop;":
                        rig.update_sun(ch == "u", ch == ";", ch == "o", ch == "p", 1 / 60)
                rig.update()
                out = frame_path(frame, True)
                dt = draw(scene, lights, out)
                print(f"frame {frame}: {dt * 1000:.1f} ms -> {out}", file=sys.stderr)
                frame += 1
            return 0

        for frame in range(args.frames):
            rig.update()
            if args.spotlights and frame > 0:
                # rotate the two spots (src/main.rs:1243-1256)
                angle = 0.5 / 60.0 * frame
                new_dirs = lights.spot_direction.cpu().numpy().copy()
                for k, phase in ((len(light_list) - 2, 0.0), (len(light_list) - 1, np.pi)):
                    a = angle + phase
                    new_dirs[k] = [np.sin(a), 0.0, np.cos(a)]
                lights = lights._replace(spot_direction=torch.from_numpy(new_dirs).to(dev))
            if args.rotate_model and frame > 0:
                # rotate the last instance (src/main.rs:1258-1283)
                from transmission_renderer_tpu_torch.scene.types import (
                    quat_from_rotation_y,
                    quat_mul,
                )

                delta = torch.from_numpy(quat_from_rotation_y(1.0 / 60.0)).to(dev)
                rot = scene.inst_transform.rotation.clone()
                rot[-1] = quat_mul(delta, rot[-1])
                scene = scene._replace(inst_transform=scene.inst_transform._replace(rotation=rot))
            out = frame_path(frame, args.frames > 1)
            dt = draw(scene, lights, out)
            print(f"frame {frame}: {dt * 1000:.1f} ms -> {out}")
            # simple orbit for multi-frame renders
            rig.target_yaw += 0.1
    return 0


def _overlay_fn(args, config, dev):
    """The cluster-wireframe overlay of the frame (cli.py:334-367), or the
    identity."""
    if args.cluster_wireframe is None:
        return lambda ldr: ldr
    import torch

    from transmission_renderer_tpu_torch.pbr.clustering import (
        cluster_coefficients,
        write_cluster_data,
    )
    from transmission_renderer_tpu_torch.render.cluster_debug import cluster_wireframe_overlay
    from transmission_renderer_tpu_torch.scene.camera import perspective_matrix_reversed

    proj = torch.from_numpy(perspective_matrix_reversed(
        config.width, config.height, config.vertical_fov, config.z_near, config.z_far,
    )).to(dev)
    coeffs = cluster_coefficients(config.z_near, config.z_far, config.num_depth_slices)

    def apply_overlays(ldr):
        amin, amax = write_cluster_data(
            torch.linalg.inv(proj), (config.width, config.height),
            (config.num_clusters_x, config.num_clusters_y), coeffs,
        )
        if args.cluster_wireframe >= 0:
            # clusters are indexed slice * cy * cx + y * cx + x
            # (shader/src/lib.rs:527-529)
            per = config.num_clusters_x * config.num_clusters_y
            s = args.cluster_wireframe * per
            amin, amax = amin[s : s + per], amax[s : s + per]
        return cluster_wireframe_overlay(ldr, amin, amax, proj)

    return apply_overlays


if __name__ == "__main__":
    sys.exit(main())
