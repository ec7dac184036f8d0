"""transmission_renderer_tpu_torch — the PyTorch + CUDA port of
``transmission_renderer_tpu``.

The JAX package beside this one is the reference. This package keeps its
directory layout and module names, so each module's counterpart sits at
the same path under ``transmission_renderer_tpu/``; every module's
docstring names it.

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package: where it needs a JAX-free module of the reference (the
``RenderConfig``, the GGX LUT bake), it keeps its own copy
(``config.py``, ``utils/ggx_lut.py``).

Plain tensor work is PyTorch. Every Pallas kernel of the reference (on
the flagship frame, the frame with ray-traced shadows and the
visibility-buffer frame) is a
hand-written CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc``
at first use (``kernels.py``). Each kernel's wrapper takes its plain
PyTorch version for CPU tensors and launches the kernel for CUDA
tensors. Entry points that create tensors put them on the card unless
the caller passes ``device="cpu"``, and raise when there is no card.
"""

__version__ = "0.1.0"

from transmission_renderer_tpu_torch.config import RenderConfig  # noqa: F401, E402
