"""Fused int4-dequant matmul for the weight-only int4 MLP.

Kernel: csrc/int4_matmul.cu, which replaces the Pallas kernel
fangyan_tts_tpu/ops/int4_matmul.py `int4_matmul` (body `_kernel` :29,
pallas_call at :57). It computes x (M, K) @ W with W nibble-packed int4
(K//2, N) int8 (ops/quant.quantize_int4_packed) and a per-output-channel
float32 scale applied to the float32 sum before the cast to bf16.

On the H100 it is bound by bytes at decode (M = 1-16: the packed weight,
4.4 MB for gate_up_proj, is read once and reused only M times) and by
operations at prefill (M in the hundreds). The design streams the packed
bytes through shared memory in a cp.async ring and dequantizes them in
registers straight into mma.sync m16n8k16 operands: one packed byte holds
the two consecutive K values a thread's B fragment needs, so the Pallas
kernel's even/odd activation split (a TPU relayout workaround) is not
needed. Where the output tiles alone cannot fill the card (down_proj has
7 tiles of 128 columns), K is split over blocks and a second pass sums the
float32 partials in a fixed order (no atomics: the result does not change
from run to run). See the source for the design.

`int4_matmul` launches the kernel for CUDA tensors and runs
`int4_matmul_plain` (ops/quant.int4_dot) for CPU tensors; there is no
fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import _build
from .quant import int4_dot

launches = 0  # kernel launches since the last reset (CPU calls do not count)
BLOCK_N = 128  # output columns per block (kBn in the source)
BLOCK_K = 64  # input rows per pipeline step (kBk in the source)


def int4_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ops/quant.int4_dot (the JAX package's
    `int4_dot` op for op, the product taken in x's dtype)."""
    return int4_dot(x, w_packed, scale)


def plan(m: int, k: int, n: int, sms: int) -> tuple[int, int, int]:
    """(rows per block, K splits, pipeline steps per split) for an (m, k, n)
    product on a card of `sms` streaming multiprocessors: 16-row tiles up to
    m = 16, else 64; K is split only while the output tiles number fewer
    than the SMs, up to two blocks an SM and at least two steps a split."""
    bm = 16 if m <= 16 else 64
    tiles = (n // BLOCK_N) * -(-m // bm)
    steps = k // BLOCK_K
    splits = 1
    if tiles < sms:
        splits = max(1, min(-(-2 * sms // tiles), steps // 2))
    per = -(-steps // splits)
    return bm, -(-steps // per), per


def _check(x, w_packed, scale):
    dev = x.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"int4_matmul: x is on {dev}, the current CUDA device is {torch.cuda.current_device()}")
    for name, t in (("x", x), ("w_packed", w_packed), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"int4_matmul: {name} is on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4_matmul: {name} must be contiguous and 16-byte aligned")
    if x.dtype != torch.bfloat16 or w_packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"int4_matmul: takes x bfloat16, w_packed int8 and scale float32, got "
                         f"{x.dtype}, {w_packed.dtype}, {scale.dtype}")
    k = x.shape[-1]
    if w_packed.dim() != 2 or w_packed.shape[0] * 2 != k or scale.shape != (w_packed.shape[1],):
        raise ValueError(f"int4_matmul: x (..., {k}) does not fit w_packed {tuple(w_packed.shape)} "
                         f"and scale {tuple(scale.shape)}")
    n = w_packed.shape[1]
    if k % BLOCK_K or n % BLOCK_N or x.numel() == 0:
        raise ValueError(f"int4_matmul: K={k} must be a multiple of {BLOCK_K}, N={n} of {BLOCK_N}, M >= 1")


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (…, K) @ dequant(w_packed (K//2, N)) * scale (N,) -> (…, N) in x's
    dtype. CPU tensors take the plain version; CUDA tensors launch
    csrc/int4_matmul.cu or raise."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    _check(x, w_packed, scale)
    k, n = x.shape[-1], w_packed.shape[1]
    m = x.numel() // k
    bm, splits, per = plan(m, k, n, torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    # float32 partial sums of the K splits, (splits, M, N); none without a split
    ws = torch.empty((splits * m * n) if splits > 1 else 0, dtype=torch.float32, device=x.device)
    fn = _build.load("int4_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
              m, k, n, bm, splits, per, stream)
    _build.check("int4_matmul", code)
    global launches
    launches += 1
    return out
