"""The frame: G-buffer, shading, sparse worklists, render_frame
(counterpart of ``transmission_renderer_tpu/render``)."""
