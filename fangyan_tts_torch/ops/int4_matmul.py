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

Float32 x takes the kernel's float32 route, `fangyan_int4_matmul_f32`:
SIMT kernels with float32 FMAs and no tensor cores (so no TF32 rounding)
and a float32 result; the Pallas kernel writes x's dtype. One launch a
call (`plan_f32`), of one of two tiles: up to M = 16 a decode tile that
streams the packed weight through registers (each byte read once,
dequantized in registers) against x staged in shared memory, above it a
register-blocked GEMM tile (8 x 8 or 8 x 16 outputs a thread) on a
cp.async ring. Both split K over a thread-block cluster where the output
tiles leave SMs idle and sum the partials in rank order through
distributed shared memory, in the same launch. The wrapper picks the
route by x's dtype and counts a launch in ops/device.launches under the
route's name, `int4_matmul` or `int4_matmul_f32`.

`int4_matmul` launches the kernel for CUDA tensors and runs
`int4_matmul_plain` (ops/quant.int4_dot) for CPU tensors; there is no
fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import _build
from .device import launched, refuse_grad
from .quant import int4_dot

# x's dtype -> C entry, also the route's name in ops/device.launches
ROUTES = {torch.bfloat16: "int4_matmul", torch.float32: "int4_matmul_f32"}
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


F32_DECODE_M = (4, 8, 16)  # the float32 decode tile's token buckets: M up to 16 takes the smallest that holds it
F32_PREFILL_M = 128  # the float32 prefill tile's tokens a block, above 16
F32_STEP_K = {4: 64, 8: 64, 16: 64, F32_PREFILL_M: 32}  # K a step, by tile_m
F32_TILE_N = (128, 64)  # output channels a float32 block covers
F32_BLOCKS_PER_SM = 2  # blocks of the decode tile an SM holds
F32_STEP_COST = 2  # a prefill block's fixed cost (ring fill, partial sum, store) in steps


def plan_f32(m: int, k: int, n: int, sms: int) -> tuple[int, int, int, int]:
    """(tile_m, channels a block covers, cluster size, K steps a cluster
    block sums) of the float32 route for an (m, k, n) product on a card of
    `sms` streaming multiprocessors, in one launch, in the shape of `plan`.

    Up to m = 16 the decode tile, tile_m the smallest of F32_DECODE_M that
    holds m; above, the prefill tile of F32_PREFILL_M tokens. A block
    covers 128 channels, or 64 where blocks of 128 split over whole
    clusters would still leave SMs idle (down_proj's N = 896). K is split
    over a cluster of up to MAX_CLUSTER blocks where the output tiles leave
    SMs idle: at decode as many as keep every block resident at once
    (F32_BLOCKS_PER_SM an SM); at prefill the cluster size that finishes
    soonest when each SM works through ceil(blocks / sms) blocks of `per` +
    F32_STEP_COST steps, so a split wins only where the output tiles leave
    SMs idle in their last round. (Where the prefill blocks do not
    outnumber the SMs, the kernel gives each block two groups of threads
    that share its steps.) K goes in steps of F32_STEP_K[tile_m]."""
    tile_m = next(b for b in F32_DECODE_M if m <= b) if m <= F32_DECODE_M[-1] else F32_PREFILL_M
    steps = k // F32_STEP_K[tile_m]
    token_tiles = -(-m // tile_m)
    resident = F32_BLOCKS_PER_SM * sms
    wide, narrow = F32_TILE_N
    tile_n = wide if n % wide == 0 and n // wide * token_tiles * min(MAX_CLUSTER, steps) >= resident else narrow
    tiles = n // tile_n * token_tiles
    if tile_m != F32_PREFILL_M:
        cs = max(1, min(MAX_CLUSTER, steps, resident // tiles))
    else:
        cs = min(range(1, min(MAX_CLUSTER, steps) + 1),
                 key=lambda c: (-(-tiles * c // sms) * (-(-steps // c) + F32_STEP_COST), c))
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
    if x.dtype not in ROUTES or w_packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"int4_matmul: takes x bfloat16 or float32, w_packed int8 and scale float32, got "
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
    csrc/int4_matmul.cu (the bf16 route for bfloat16 x, the float32 route
    for float32 x) or raise (also when x requires grad: the kernel has no
    backward)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    refuse_grad("int4_matmul", "float weights (quantization is an inference mode)", x)
    _check(x, w_packed, scale)
    k, n = x.shape[-1], w_packed.shape[1]
    m = x.numel() // k
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    entry = ROUTES[x.dtype]
    args = (x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan_of = plan_f32 if x.dtype == torch.float32 else plan
    _build.check(entry, _build.load(entry)(*args, *plan_of(m, k, n, sms), stream))
    launched(entry)
    return out
