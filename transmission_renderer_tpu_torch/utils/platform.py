"""Matmul precision.

Counterpart of ``transmission_renderer_tpu/utils/platform.py::f32_matmuls``.
The reference pins full-f32 matmuls because reduced precision shifts
geometry (docs/FIDELITY.md section 4). PyTorch's float32 matmul on the
card is full f32 by default, but a float32 convolution goes through
cuDNN in TF32 by default; both switches are stated here explicitly.
"""

from __future__ import annotations

import torch


def f32_matmuls() -> None:
    """Turn TF32 off for matmuls and cuDNN (full-f32 products)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
