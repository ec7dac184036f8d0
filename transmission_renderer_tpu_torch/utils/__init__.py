"""Utilities: the GGX LUT, a stdlib PNG codec and JPEG decoder, profiling
ranges and the frame tracer, matmul precision (counterpart of
``transmission_renderer_tpu/utils``, with its names: ``save_png`` and
``load_png`` are utils/png.py's ``write_png`` and ``read_png``)."""

from transmission_renderer_tpu_torch.utils.ggx_lut import (  # noqa: F401
    compute_ggx_lut,
    default_ggx_lut,
)
from transmission_renderer_tpu_torch.utils.png import read_png as load_png  # noqa: F401
from transmission_renderer_tpu_torch.utils.png import write_png as save_png  # noqa: F401
