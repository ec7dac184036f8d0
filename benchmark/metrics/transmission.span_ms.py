"""The transmissive half of the frame on the device timeline per frame
(render/frame.py: the opaque mip pyramid, kernel 1's transmissive raster
seeded with the opaque depth, and the transmission shade, kernels 3 and
4), the ``mip_pyramid``, ``raster_transmission`` and
``shade_transmission`` spans timed by CUDA events
(benchmark/core/spans.py). With ray-traced shadows the transmission
pass's shadow rays run inside ``shade_transmission``; their span,
``shadow_rays_transmission``, is read by ``shadow_rays.span_ms`` and is
taken out here, so that the two layers do not overlap. Nothing where the
scene has no glass."""


def read(trace):
    glass = trace.span_ms({"mip_pyramid", "raster_transmission", "shade_transmission"})
    if glass is None:
        return None
    return glass - (trace.span_ms({"shadow_rays_transmission"}) or 0.0)
