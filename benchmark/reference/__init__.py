"""Plain float32 PyTorch references of the benchmark's models.

Each module is a straightforward forward pass of one model, with no
kernels, caches or batching, in the parameter names of the system under
test so that one state dict made by the benchmark loads into both. Nothing
here imports the system under test or JAX. The caller turns TF32 off
(`exact_float32`) before a reference runs on the card.
"""

from __future__ import annotations

import torch


def exact_float32() -> None:
    """Full float32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
