"""Render configuration and draw-bucket constants.

Counterpart of ``transmission_renderer_tpu/config.py``, which is plain
Python (no JAX at import time): the port shares its ``RenderConfig`` and
``BUCKET_*`` constants rather than copying them, so both packages read
one configuration. Code of the port and its callers import them from
here.
"""

from transmission_renderer_tpu.config import (  # noqa: F401
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
    RenderConfig,
)
