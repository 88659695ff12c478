"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """None means CUDA. Raises when CUDA is asked for and there is none:
    entry points never carry on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fangyan_tts_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the CPU reference path"
        )
    return dev


def refuse_grad(kernel: str, route: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a kernel call: the hand-written CUDA
    kernels have no backward, so their output would carry no grad_fn and
    the inputs' gradients would be dropped without a word. `route` names
    the differentiable plain-PyTorch route the caller should select."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: the CUDA kernel has no backward and an input requires grad; "
                           f"run it under torch.no_grad(), or take {route}")


def exact_fp32() -> None:
    """Pin full-precision float32 matmuls and convolutions on the card.
    cuDNN convolutions default to TF32, which keeps about three decimal
    digits; the STFT bases and the f0 predictor need float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
