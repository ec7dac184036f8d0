"""The port's debug-checks frame (render/checks.py, --debug-checks) against
the reference's contract (tests/test_checks.py): a clean frame prints
nothing and is bit-equal to the unchecked frame; an out-of-range index at
a covered site is reported with ``out-of-bounds``; ray-traced shadows are
refused. At tests/golden_defs.py::CFG (128x72, 32x8 tiles) on the
visibility-buffer branch, on the reference's test scene and on the stress
scene, whose alpha clip runs kernel 6's alpha form. The CLI: --cpu
--debug-checks renders and reports nothing; beside --ray-tracing,
--as-debug or --devices 2 it exits 2 with the reference's message.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from golden_defs import CFG, _rig
from transmission_renderer_tpu_torch import cli
from transmission_renderer_tpu_torch.models.procedural import build_stress_scene, build_test_scene
from transmission_renderer_tpu_torch.ops import raster_vis
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render import checks
from transmission_renderer_tpu_torch.render.checks import checked_frame_fn
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame

torch.set_num_threads(1)

VIS = dataclasses.replace(CFG, use_pallas_raster=False)
SMALL = ["--width", "128", "--height", "72"]


def _bundle(name: str):
    """(scene, draw list, flags, params, lights) of tests/test_checks.py's
    test scene and camera, or of the stress golden's."""
    if name == "test":
        scene, dl, flags = build_test_scene().finish_bundle(device="cpu")
        rig = _rig((0.0, 2.2, 1.5), -0.25)
    else:
        scene, dl, flags = build_stress_scene(grid=3).finish_bundle(device="cpu")
        rig = _rig((0.0, 3.0, 2.5), -0.5)
    params = make_frame_params(VIS, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    return scene, dl, flags, params, lights


@pytest.mark.parametrize("name", ["test", "stress"])
def test_clean_frame_reports_nothing_and_matches(name):
    scene, dl, flags, params, lights = _bundle(name)
    log = io.StringIO()
    img = checked_frame_fn(config=VIS, flags=flags, out=log)(scene, dl, params, lights)
    assert log.getvalue() == ""
    assert not checks.active()
    assert torch.equal(img, render_frame(scene, dl, params, lights, VIS, flags=flags))
    assert flags.has_alpha_clip == (name == "stress")


def test_out_of_range_texture_is_reported():
    """The stress scene's clip materials with a diffuse texture past the
    atlas: the alpha test's meta row and the material matrix's report it,
    one line each, and the frame goes on (XLA's clamp, as the reference)."""
    scene, dl, flags, params, lights = _bundle("stress")
    m = scene.materials
    n_images = scene.atlas_meta.shape[0]
    bad = torch.where(m.tex_diffuse >= 0, torch.full_like(m.tex_diffuse, n_images),
                      m.tex_diffuse)
    scene = scene._replace(materials=m._replace(tex_diffuse=bad))
    log = io.StringIO()
    img = checked_frame_fn(config=VIS, flags=flags, out=log)(scene, dl, params, lights)
    lines = log.getvalue().splitlines()
    print("\n".join(lines))
    assert lines and all("out-of-bounds" in ln for ln in lines)
    assert len(set(lines)) == len(lines)
    assert any(raster_vis.CHECK_SITES[5] in ln for ln in lines)
    assert any("build_material_matrix" in ln for ln in lines)
    assert bool(torch.isfinite(img).all())


def test_run_start_past_the_records_is_reported():
    """Kernel 6's plain version under checks: a run start past the records
    (sequential and segmented) is reported; the row read is the clamped one,
    as XLA reads it."""
    scene, dl, flags, params, lights = _bundle("test")
    raster_vis.KERNEL.recorder = []
    try:
        render_frame(scene, dl, params, lights, VIS, flags=flags)
    finally:
        calls, raster_vis.KERNEL.recorder = raster_vis.KERNEL.recorder, None
    args, kw = calls[0]
    run_start = args[2].clone()
    k = int(torch.argmax(args[3]))
    run_start[k] = args[0][0].shape[0]
    bad_args = args[:2] + (run_start,) + args[3:]
    for segment in (None, raster_vis.SEG):
        with checks.collect() as found:
            raster_vis.raster_vis_plain(*bad_args, **kw, segment=segment)
        assert [site for site, _ in found] == [raster_vis.CHECK_SITES[0]], found
        assert found[0][1] > 0
        assert "out-of-bounds" in checks.report_line(*found[0])
    with checks.collect() as found:
        raster_vis.raster_vis_plain(*args, **kw)
    assert found == []


def test_checks_refuse_ray_tracing():
    with pytest.raises(ValueError, match="RT path"):
        checked_frame_fn(config=dataclasses.replace(VIS, ray_traced_shadows=True),
                         flags=None)


def test_cli_debug_checks_renders_silently(tmp_path, capsys):
    """--cpu --debug-checks on the stress scene: exit 0, a PNG, the checked
    frame equal to the unchecked one, no report."""
    frames = []
    argv = ["--cpu", "--procedural", "stress"] + SMALL
    assert cli.main(argv + ["--debug-checks", "-o", str(tmp_path / "c.png")],
                    frames_out=frames) == 0
    err = capsys.readouterr().err
    assert "out-of-bounds" not in err and "CHECKS" not in err
    assert cli.main(argv + ["-o", str(tmp_path / "u.png")], frames_out=frames) == 0
    assert (tmp_path / "c.png").exists()
    np.testing.assert_array_equal(frames[0], frames[1])


@pytest.mark.parametrize("flag", [["--ray-tracing"], ["--as-debug"], ["--devices", "2"]])
def test_cli_debug_checks_refuses_what_the_reference_refuses(flag, tmp_path, capsys):
    argv = ["--cpu", "--procedural", "test", "--debug-checks", "-o",
            str(tmp_path / "r.png")] + SMALL + flag
    assert cli.main(argv) == 2
    assert "--debug-checks supports the single-device non-RT frame path only" in \
        capsys.readouterr().err
    assert not (tmp_path / "r.png").exists()
