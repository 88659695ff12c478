"""Device resolution shared by the port's entry points, and the one count of
the hand-written kernels' launches (`launches`, `launched`)."""

from __future__ import annotations

import collections
import contextlib
import threading

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


KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # the dtypes the Triton kernels are built for
KERNEL_DEVICES = ("cuda",)  # the device types whose tensors take a hand-written kernel


def kernel_route(*tensors) -> bool:
    """Whether a call on `tensors` (None entries skipped; the first one's
    device decides) takes its hand-written kernel rather than its plain
    PyTorch route: not where autograd records the call (the kernels have
    no backward), not under torch.compile / torch.export
    (torch.compiler.is_compiling), and only for tensors of a device type
    in KERNEL_DEVICES."""
    tensors = [t for t in tensors if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return not torch.compiler.is_compiling() and tensors[0].device.type in KERNEL_DEVICES


# kernel launches run since the last clear(), by route name: decode_attention,
# decode_attention_f32, chunk_flash_attention, chunk_flash_attention_f32,
# int4_matmul, int4_matmul_f32, adaln, moe_experts, mla_decode, rms_norm,
# qkv_rope (CPU calls and graph captures do not count; a graph's replays do)
launches: collections.Counter = collections.Counter()
_capture = threading.local()  # .tally: the launches this thread's captures record (captured_launches)


def launched(name: str, n: int = 1) -> None:
    """Count `n` launches of the route `name` on the current CUDA stream in
    `launches`; while that stream captures a CUDA graph, which records the
    launch without running it, in the capturing thread's tally instead
    (captured_launches), or nowhere where that thread keeps none. Each
    replay of the graph adds its tally to `launches` (models/decode_graphs)."""
    if not torch.cuda.is_current_stream_capturing():
        launches[name] += n
        return
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[name] += n


@contextlib.contextmanager
def captured_launches():
    """A Counter of route name -> the launches that the graphs this thread
    captures inside the block record."""
    _capture.tally = tally = collections.Counter()
    try:
        yield tally
    finally:
        _capture.tally = None


def exact_fp32() -> None:
    """Pin full-precision float32 matmuls and convolutions on the card.
    cuDNN convolutions default to TF32, which keeps about three decimal
    digits; the STFT bases and the f0 predictor need float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
