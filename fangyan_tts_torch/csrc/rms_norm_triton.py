"""Triton kernel of ops/rms_norm.py (imported there at the first launch,
never at package import: the CPU has no Triton). See ops/rms_norm.py for
the design.

One program takes one row of D; x and y are read through their row
strides. The row count and the strides are not specialized on, so one
build serves every shape of a width and dtype (two: with and without the
residual).
"""

import triton
import triton.language as tl


@triton.jit(do_not_specialize=["X_STRIDE", "Y_STRIDE"])
def fangyan_rms_norm(x_ptr, y_ptr, w_ptr, xout_ptr, norm_ptr, X_STRIDE, Y_STRIDE, eps, D: tl.constexpr,
                     BLOCK_D: tl.constexpr, RESIDUAL: tl.constexpr):
    """With RESIDUAL: x' = x + y, rounded once to x's dtype and stored; else
    x' = x. norm = x' * rsqrt(mean(x'^2) + eps) * w with float32 statistics
    over the rounded x', rounded once."""
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    x = tl.load(x_ptr + row * X_STRIDE + cols, mask=mask, other=0.0).to(tl.float32)
    if RESIDUAL:
        y = tl.load(y_ptr + row * Y_STRIDE + cols, mask=mask, other=0.0).to(tl.float32)
        xr = (x + y).to(xout_ptr.dtype.element_ty)
        tl.store(xout_ptr + row * D + cols, xr, mask=mask)
        x = xr.to(tl.float32)
    rstd = tl.rsqrt(tl.sum(x * x, axis=0) / D + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(norm_ptr + row * D + cols, (x * rstd * w).to(norm_ptr.dtype.element_ty), mask=mask)
