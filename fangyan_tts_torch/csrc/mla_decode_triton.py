"""Triton kernels of ops/mla_decode.py (imported there at the first launch,
never at package import: the CPU has no Triton). See ops/mla_decode.py
for the design.

Shapes: q (B, H, D) bf16 with D = DC + DR (the absorbed latent query and
the rope query); the layer's cache (B, S, D) bf16; bias (B, S) float32;
partials (B, NSPLIT, H, DC) float32 and their maxima and sums
(B, NSPLIT, 2, H) float32; out (B, H, DC) bf16.
"""

import triton
import triton.language as tl


@triton.jit
def fangyan_mla_decode_split(q_ptr, c_ptr, bias_ptr, part_ptr, stats_ptr, S, per, scale,
                             H: tl.constexpr, DC: tl.constexpr, DR: tl.constexpr, BS: tl.constexpr):
    b = tl.program_id(0)
    sp = tl.program_id(1)
    nsp = tl.num_programs(1)
    D: tl.constexpr = DC + DR
    heads = tl.arange(0, H)
    dc = tl.arange(0, DC)
    dr = tl.arange(0, DR)
    qb = q_ptr + b * H * D
    qc = tl.load(qb + heads[:, None] * D + dc[None, :])
    qr = tl.load(qb + heads[:, None] * D + DC + dr[None, :])
    cb = c_ptr + b.to(tl.int64) * S * D
    m_i = tl.full((H,), float("-inf"), tl.float32)
    l_i = tl.zeros((H,), tl.float32)
    acc = tl.zeros((H, DC), tl.float32)
    s0 = sp * per
    s1 = tl.minimum(s0 + per, S)
    for t0 in range(s0, s1, BS):
        ts = t0 + tl.arange(0, BS)
        bias = tl.load(bias_ptr + b * S + ts, mask=ts < s1, other=float("-inf"))
        live = bias > -1e9  # a masked slot is never read
        rows = ts.to(tl.int64)[:, None] * D
        kc = tl.load(cb + rows + dc[None, :], mask=live[:, None], other=0.0)
        kr = tl.load(cb + rows + DC + dr[None, :], mask=live[:, None], other=0.0)
        sc = tl.dot(qc, tl.trans(kc)) + tl.dot(qr, tl.trans(kr))
        sc = sc * scale + bias[None, :]
        m_new = tl.maximum(m_i, tl.max(sc, 1))
        p = tl.exp(sc - m_new[:, None])
        alpha = tl.exp(m_i - m_new)
        l_i = l_i * alpha + tl.sum(p, 1)
        acc = acc * alpha[:, None] + tl.dot(p.to(tl.bfloat16), kc)
        m_i = m_new
    slot = b * nsp + sp
    tl.store(part_ptr + slot.to(tl.int64) * H * DC + heads[:, None] * DC + dc[None, :], acc)
    tl.store(stats_ptr + slot * 2 * H + heads, m_i)
    tl.store(stats_ptr + slot * 2 * H + H + heads, l_i)


@triton.jit
def fangyan_mla_decode_merge(part_ptr, stats_ptr, out_ptr, H: tl.constexpr, DC: tl.constexpr,
                             NSPLIT: tl.constexpr):
    b = tl.program_id(0)
    heads = tl.arange(0, H)
    dc = tl.arange(0, DC)
    sp = tl.arange(0, NSPLIT)
    sb = stats_ptr + b * NSPLIT * 2 * H
    m = tl.load(sb + sp[:, None] * 2 * H + heads[None, :])
    l = tl.load(sb + sp[:, None] * 2 * H + H + heads[None, :])
    mx = tl.max(m, 0)
    den = tl.sum(tl.exp(m - mx[None, :]) * l, 0)
    acc = tl.zeros((H, DC), tl.float32)
    for i in tl.static_range(NSPLIT):
        wi = tl.exp(tl.load(sb + i * 2 * H + heads) - mx)
        part = tl.load(part_ptr + (b * NSPLIT + i).to(tl.int64) * H * DC + heads[:, None] * DC + dc[None, :])
        acc += part * wi[:, None]
    tl.store(out_ptr + b * H * DC + heads[:, None] * DC + dc[None, :], (acc / den[:, None]).to(tl.bfloat16))
