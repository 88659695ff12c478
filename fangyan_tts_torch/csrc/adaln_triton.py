"""Triton kernel of ops/adaln.py (imported there at the first launch, never
at package import: the CPU has no Triton). See ops/adaln.py for the design.

One program takes ROWS rows of the (R, D) hidden state; row r reads the
modulation rows of batch row r // L, each through its own row stride. The
row count, L and the strides are not specialized on, so one build serves
every shape of a width.
"""

import triton
import triton.language as tl


@triton.jit(do_not_specialize=["R", "L", "GATE_STRIDE", "SCALE_STRIDE", "SHIFT_STRIDE"])
def fangyan_adaln(x_ptr, y_ptr, gate_ptr, scale_ptr, shift_ptr, xout_ptr, norm_ptr, R, L, GATE_STRIDE, SCALE_STRIDE,
                  SHIFT_STRIDE, eps, D: tl.constexpr, BLOCK_D: tl.constexpr, ROWS: tl.constexpr,
                  RESIDUAL: tl.constexpr):
    """With RESIDUAL: x' = x + gate * y, rounded once to x's dtype and
    stored; else x' = x. norm = (x' - mean) * rsqrt(var + eps) * (1 + scale)
    + shift, with float32 statistics over the rounded x', rounded once."""
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_D)
    mask = (rows < R)[:, None] & (cols < D)[None, :]
    offs = rows.to(tl.int64)[:, None] * D + cols[None, :]
    batch = (rows // L).to(tl.int64)[:, None]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if RESIDUAL:
        y = tl.load(y_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(gate_ptr + batch * GATE_STRIDE + cols[None, :], mask=mask, other=0.0).to(tl.float32)
        xr = (x + g * y).to(xout_ptr.dtype.element_ty)
        tl.store(xout_ptr + offs, xr, mask=mask)
        x = xr.to(tl.float32)
    mean = tl.sum(x, axis=1) / D
    xc = tl.where(mask, x - mean[:, None], 0.0)
    rstd = 1.0 / tl.sqrt(tl.sum(xc * xc, axis=1) / D + eps)
    sc = tl.load(scale_ptr + batch * SCALE_STRIDE + cols[None, :], mask=mask, other=0.0).to(tl.float32)
    sh = tl.load(shift_ptr + batch * SHIFT_STRIDE + cols[None, :], mask=mask, other=0.0).to(tl.float32)
    out = xc * rstd[:, None] * (1.0 + sc) + sh
    tl.store(norm_ptr + offs, out.to(norm_ptr.dtype.element_ty), mask=mask)
