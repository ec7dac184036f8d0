"""The ray-traced shadow passes' spans on the device timeline per frame
(render/raytrace.py::shadow_factors in ``shadow_rays_opaque`` and
``shadow_rays_transmission``: ray set-up and kernel 5), timed by CUDA
events (benchmark/core/spans.py); nothing without ray-traced shadows."""


def read(trace):
    return trace.span_ms({"shadow_rays_opaque", "shadow_rays_transmission"})
