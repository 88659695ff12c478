"""Triton kernel of ops/qkv_rope.py (imported there at the first launch,
never at package import: the CPU has no Triton). See ops/qkv_rope.py for
the design.

One program takes one row of W = (QH + 2 KV) x HD: every head as a row of
a (BLOCK_H, HD) block. The row stride is not specialized on, so one build
serves every shape of a head layout and dtype (two: with and without the
bias).
"""

import triton
import triton.language as tl


@triton.jit(do_not_specialize=["ROW_STRIDE"])
def fangyan_qkv_rope(qkv_ptr, bias_ptr, cos_ptr, sin_ptr, out_ptr, ROW_STRIDE, QH: tl.constexpr, KV: tl.constexpr,
                     HD: tl.constexpr, BLOCK_H: tl.constexpr, BIAS: tl.constexpr):
    """h = qkv (+ bias) in float32; the first QH + KV heads (q, then k)
    rotated, h * cos + rotate_half(h) * sin with rotate_half(h) = [-h2, h1];
    the last KV heads (v) as they are. Each output rounded once."""
    row = tl.program_id(0).to(tl.int64)
    heads = tl.arange(0, BLOCK_H)[:, None]
    cols = tl.arange(0, HD)[None, :]
    half: tl.constexpr = HD // 2
    mask = (heads < QH + 2 * KV) & (cols < HD)
    offs = heads * HD + cols
    partner = heads * HD + (cols + half) % HD
    h = tl.load(qkv_ptr + row * ROW_STRIDE + offs, mask=mask, other=0.0).to(tl.float32)
    hp = tl.load(qkv_ptr + row * ROW_STRIDE + partner, mask=mask, other=0.0).to(tl.float32)
    if BIAS:
        h += tl.load(bias_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        hp += tl.load(bias_ptr + partner, mask=mask, other=0.0).to(tl.float32)
    c = tl.load(cos_ptr + row * HD + cols).to(tl.float32)
    s = tl.load(sin_ptr + row * HD + cols).to(tl.float32)
    rotated = h * c + tl.where(cols < half, -hp, hp) * s
    out = tl.where(heads < QH + KV, rotated, h)
    tl.store(out_ptr + row * (QH + 2 * KV) * HD + offs, out.to(out_ptr.dtype.element_ty), mask=mask)
