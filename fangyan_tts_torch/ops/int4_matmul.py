"""Fused int4-dequant matmul for the weight-only int4 MLP.

Kernel: csrc/int4_matmul.cu, which replaces the Pallas kernel
fangyan_tts_tpu/ops/int4_matmul.py `int4_matmul` (body `_kernel` :29,
pallas_call at :57). It computes x (M, K) @ W with W nibble-packed int4
(K//2, N) int8 (ops/quant.quantize_int4_packed) and a per-output-channel
float32 scale applied to the float32 sum before the cast to bf16.

On the H100 it is bound by bytes at decode (M = 1-16: the packed weight,
4.4 MB for gate_up_proj, is read once and reused only M times) and by
operations at prefill (M in the hundreds). The kernel computes the product
transposed on wgmma, with the weight dequantized by bit operations into the
A operand in registers and x read by wgmma from shared memory; TMA fills a
ring of stages behind mbarriers. One launch at every M (`plan`): a block
covers 16 or 128 tokens and 64, 128 or 256 output channels, and where the
output tiles do not fill the card K is split over the blocks of a
thread-block cluster, which sum their partials through distributed shared
memory in rank order. See the source for the design.

`int4_matmul` launches the kernel for CUDA tensors and runs
`int4_matmul_plain` (ops/quant.int4_dot) for CPU tensors; there is no
fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import _build
from .device import refuse_grad
from .quant import int4_dot

launches = 0  # kernel launches since the last reset (CPU calls do not count)
BLOCK_N = 128  # N must be a multiple of this: the output channels of a prefill block
BLOCK_K = 64  # K must be a multiple of this (kBk in the source)
DECODE_TILE_M = 16  # tokens per block up to this M (decode)
PREFILL_TILE_M = 128  # tokens per block above it
STEP_K = {DECODE_TILE_M: 256, PREFILL_TILE_M: 64}  # K per pipeline step, by tokens a block covers
MAX_CLUSTER = 8  # the largest portable thread-block cluster


def int4_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ops/quant.int4_dot (the JAX package's
    `int4_dot` op for op, the product taken in x's dtype)."""
    return int4_dot(x, w_packed, scale)


def plan(m: int, k: int, n: int, sms: int) -> tuple[int, int, int, int]:
    """(tokens a block covers, its output channels, cluster size, K steps a
    cluster block sums) for an (m, k, n) product on a card of `sms`
    streaming multiprocessors, in one launch. Up to m = DECODE_TILE_M a
    block covers those tokens and 64 channels (two blocks an SM); above, 128
    tokens and 128 channels, or 256 where those blocks alone fill the card
    (each x row then serves twice the channels). Where the output tiles
    leave blocks idle, K is split over a cluster of up to MAX_CLUSTER
    blocks, as many as keep every block resident at once. K goes in steps
    of STEP_K[tokens]."""
    tile_m = DECODE_TILE_M if m <= DECODE_TILE_M else PREFILL_TILE_M
    steps = -(-k // STEP_K[tile_m])
    token_tiles = -(-m // tile_m)
    wide = 2 * BLOCK_N
    if tile_m == DECODE_TILE_M:
        tile_n, resident = BLOCK_N // 2, 2 * sms
    elif n % wide == 0 and n // wide * token_tiles >= sms:
        tile_n, resident = wide, sms
    else:
        tile_n, resident = BLOCK_N, sms
    cs = max(1, min(MAX_CLUSTER, steps, resident // (n // tile_n * token_tiles)))
    per = -(-steps // cs)
    return tile_m, tile_n, -(-steps // per), per


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
    csrc/int4_matmul.cu or raise (also when x requires grad: the kernel has
    no backward)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    refuse_grad("int4_matmul", "float weights (quantization is an inference mode)", x)
    _check(x, w_packed, scale)
    k, n = x.shape[-1], w_packed.shape[1]
    m = x.numel() // k
    tile_m, tile_n, cs, per = plan(m, k, n, torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    fn = _build.load("int4_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n, tile_m, tile_n, cs, per,
              stream)
    _build.check("int4_matmul", code)
    global launches
    launches += 1
    return out
