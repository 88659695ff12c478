"""Triton kernels of ops/moe.py (imported there at the first launch, never
at package import: the CPU has no Triton). See ops/moe.py for the design.

Both kernels run on a fixed (experts, column tiles) grid. A program loads
its expert's [start, end) in the expert-sorted item list and walks those
items in tiles of BM rows; an expert with no items runs no iteration.
Items are flat (row, slot) indices: row = item // TOPK.
"""

import triton
import triton.language as tl


@triton.jit
def fangyan_moe_gate_up(x_ptr, w_ptr, order_ptr, off_ptr, h_ptr, D, I, TOPK,
                        BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
    """h[pos, n] = silu(x[row] . W_gate[e, n]) * (x[row] . W_up[e, n]) for the
    expert's sorted positions pos and a BN tile of the I columns; x (N, D),
    W (E, 2I, D) bf16, h (N TOPK, I) bf16."""
    e = tl.program_id(0)
    n0 = tl.program_id(1) * BN
    start = tl.load(off_ptr + e)
    end = tl.load(off_ptr + e + 1)
    cols = n0 + tl.arange(0, BN)
    ks = tl.arange(0, BK)
    w_base = w_ptr + e.to(tl.int64) * 2 * I * D
    for m0 in range(start, end, BM):
        r = m0 + tl.arange(0, BM)
        rmask = r < end
        items = tl.load(order_ptr + r, mask=rmask, other=0)
        rows = (items // TOPK).to(tl.int64)
        acc_g = tl.zeros((BM, BN), dtype=tl.float32)
        acc_u = tl.zeros((BM, BN), dtype=tl.float32)
        for k0 in range(0, D, BK):
            xt = tl.load(x_ptr + rows[:, None] * D + (k0 + ks)[None, :], mask=rmask[:, None], other=0.0)
            wg = tl.load(w_base + cols[None, :] * D + (k0 + ks)[:, None])
            wu = tl.load(w_base + (I + cols)[None, :] * D + (k0 + ks)[:, None])
            acc_g = tl.dot(xt, wg, acc_g)
            acc_u = tl.dot(xt, wu, acc_u)
        hv = acc_g * tl.sigmoid(acc_g) * acc_u
        tl.store(h_ptr + r.to(tl.int64)[:, None] * I + cols[None, :], hv.to(tl.bfloat16), mask=rmask[:, None])


@triton.jit
def fangyan_moe_down(h_ptr, w_ptr, order_ptr, off_ptr, wt_ptr, out_ptr, D, I,
                     BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
    """out[item, n] = weight[item] * (h[pos] . W_down[e, n]) for a BN tile of
    the D output columns; h (N TOPK, I) bf16 by sorted position, W_down
    (E, D, I) bf16, weight (N TOPK,) float32, out (N TOPK, D) float32 by
    item."""
    e = tl.program_id(0)
    n0 = tl.program_id(1) * BN
    start = tl.load(off_ptr + e)
    end = tl.load(off_ptr + e + 1)
    cols = n0 + tl.arange(0, BN)
    ks = tl.arange(0, BK)
    w_base = w_ptr + e.to(tl.int64) * D * I
    for m0 in range(start, end, BM):
        r = m0 + tl.arange(0, BM)
        rmask = r < end
        items = tl.load(order_ptr + r, mask=rmask, other=0)
        acc = tl.zeros((BM, BN), dtype=tl.float32)
        for k0 in range(0, I, BK):
            ht = tl.load(h_ptr + r.to(tl.int64)[:, None] * I + (k0 + ks)[None, :], mask=rmask[:, None], other=0.0)
            wd = tl.load(w_base + cols[None, :] * I + (k0 + ks)[:, None])
            acc = tl.dot(ht, wd, acc)
        wt = tl.load(wt_ptr + items, mask=rmask, other=0.0)
        acc = acc * wt[:, None]
        tl.store(out_ptr + items.to(tl.int64)[:, None] * D + cols[None, :], acc, mask=rmask[:, None])
