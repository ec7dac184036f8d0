"""The frame: G-buffer, shading, sparse worklists, render_frame
(counterpart of ``transmission_renderer_tpu/render``, with its names:
DrawList, FrameParams, SceneFlags, build_draw_list, make_frame_params,
render_frame, scene_flags).

The names load render/frame.py at first use: the ops that
render/checks.py instruments import this package, and render/frame.py
imports those ops.
"""

import importlib

_FRAME_NAMES = ("DrawList", "FrameParams", "SceneFlags", "build_draw_list",
                "make_frame_params", "render_frame", "scene_flags")
__all__ = list(_FRAME_NAMES)


def __getattr__(name):
    if name in _FRAME_NAMES:
        return getattr(importlib.import_module(f"{__name__}.frame"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
