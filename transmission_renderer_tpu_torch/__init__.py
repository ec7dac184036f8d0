"""transmission_renderer_tpu_torch — the PyTorch + CUDA port of
``transmission_renderer_tpu``.

The JAX package beside this one is the reference. This package keeps its
directory layout and module names, so each module's counterpart sits at
the same path under ``transmission_renderer_tpu/``; every module's
docstring names it.

The port imports ``torch`` and never ``jax``. Of the JAX package it reads
only two JAX-free modules: ``transmission_renderer_tpu.config``
(``RenderConfig``, the draw-bucket constants; re-exported by this
package's ``config``) and ``transmission_renderer_tpu.utils.ggx_lut``
(NumPy).

Plain tensor work is PyTorch. Every Pallas kernel on the flagship frame's
path is a hand-written CUDA C++ kernel for Hopper (``csrc/``), built with
``nvcc`` at first use (``kernels.py``). Each kernel's wrapper takes its
plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors.
"""

__version__ = "0.1.0"
