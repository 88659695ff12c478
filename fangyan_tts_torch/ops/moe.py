"""Routed experts of an MoE layer: a grouped expert GEMM that reads each
touched expert's weights once a call and never tells the host how many
rows an expert got.

Kernel: csrc/moe_experts_triton.py (Triton), which replaces no TPU kernel:
the JAX package has no MoE layer. It was added for the MLA-MoE speech LM
(models/mla_moe.py), whose decode step spends most of its bytes here. At
decode (16 rows, 6 experts a row) each expert sees one or two rows, so a
call is bound by the touched experts' weights (17.3 MB each at
Moonlight's widths) and nothing else; at a 1.5 k-row prefill an expert's
rows are still fewer than the ~295 operations a byte at which the H100's
tensor cores take over from its memory. So the design spends nothing on
reuse across experts and everything on streaming each expert's weights
once:

- Routing on the device. The (row, expert, weight) triples of the call
  are sorted by expert with a one-hot prefix sum (stable, deterministic),
  which gives each expert's offset into the sorted list. No `.item()`, no
  `nonzero`: nothing is read back.
- A fixed grid. Each launch runs (experts, column tiles) programs; a
  program reads its expert's offset and count from the device and loops
  over that expert's rows in tiles of BM (BM_WIDE where the call's shape
  gives an expert many rows on average), so an expert with no rows exits
  at once and the grid never depends on the routing. A decode step can
  therefore be captured in a CUDA graph (models/decode_graphs.py) and
  replayed with other routings.
- Two launches. `fangyan_moe_gate_up` computes silu(x W_gate^T) * (x W_up^T)
  for its expert's rows and a tile of the 1,408 intermediate columns
  (float32 sums, the product stored in bf16 by sorted position);
  `fangyan_moe_down` multiplies that by W_down^T for a tile of the output
  columns, scales each row by its routing weight and writes it, in
  float32, to the row's own (row, slot) place. The wrapper then sums each
  row's k slots in a fixed order, so the result is the same at every call,
  eager or replayed.

`moe_experts` launches the kernels for CUDA tensors (bfloat16 rows and
weights only; it raises on anything else) and runs `moe_experts_plain`
for CPU tensors; there is no fallback from one to the other. Both add
[1, experts with at least one row, routed rows] to an optional (3,) int64
`stats` tensor on the device. Each launch counts as `moe_experts` in
ops/device.launches (a captured launch is tallied for its graph instead).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .device import launched, refuse_grad

BM = 16  # rows of a tile (tl.dot's least M); an expert's rows run in tiles of BM
BM_WIDE, WIDE_ROWS = 64, 32  # the tile where the call gives an expert WIDE_ROWS rows or more on average (a prefill)
BN_GATE_UP, BK_GATE_UP = 64, 128
BN_DOWN, BK_DOWN = 64, 64


def route_order(experts: torch.Tensor, n_experts: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """experts (N, k) -> (order (N k,) int32: the flat (row, slot) items
    sorted by expert, stable; offsets (E + 1,) int32 into it; counts (E,)).
    One-hot prefix sums: no host read."""
    flat = experts.reshape(-1)
    n = flat.numel()
    one_hot = (flat[:, None] == torch.arange(n_experts, device=flat.device)[None, :]).to(torch.int32)
    counts = one_hot.sum(dim=0)
    ends = counts.cumsum(0)
    rank = (one_hot.cumsum(0) - one_hot).gather(1, flat[:, None])[:, 0]
    pos = (ends - counts)[flat] + rank
    order = torch.empty(n, dtype=torch.int32, device=flat.device)
    order.scatter_(0, pos, torch.arange(n, dtype=torch.int32, device=flat.device))
    offsets = torch.cat([torch.zeros(1, dtype=ends.dtype, device=flat.device), ends]).to(torch.int32)
    return order, offsets, counts


def _add_stats(stats: torch.Tensor | None, counts: torch.Tensor, n_items: int) -> None:
    if stats is not None:
        stats += torch.stack([torch.ones_like(counts[0]), (counts > 0).sum(), torch.full_like(counts[0], n_items)]
                             ).to(stats.dtype)


def moe_experts_plain(x, experts, weights, w_gate_up, w_down, stats=None) -> torch.Tensor:
    """Plain PyTorch version: for each expert, its rows through
    silu(x W_gate^T) * (x W_up^T) W_down^T in x's dtype, scaled by their
    routing weights and summed in float32.

    x (N, D); experts (N, k) int64; weights (N, k) float32; w_gate_up
    (E, 2I, D); w_down (E, D, I). Returns (N, D) in x's dtype."""
    n, d = x.shape
    e_count = w_gate_up.shape[0]
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    _, _, counts = route_order(experts, e_count)
    for e in range(e_count):
        rows, slots = (experts == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        gate, up = F.linear(x[rows], w_gate_up[e].to(x.dtype)).chunk(2, dim=-1)
        h = (F.silu(gate.float()) * up.float()).to(x.dtype)
        y = F.linear(h, w_down[e].to(x.dtype)).float()
        out.index_add_(0, rows, y * weights[rows, slots, None].float())
    _add_stats(stats, counts, experts.numel())
    return out.to(x.dtype)


def _check(x, experts, weights, w_gate_up, w_down):
    dev = x.device
    if any(t.device != dev for t in (experts, weights, w_gate_up, w_down)):
        raise ValueError("moe_experts: every tensor must be on x's device")
    if not (x.dtype == w_gate_up.dtype == w_down.dtype == torch.bfloat16):
        raise ValueError("moe_experts: the CUDA route takes bfloat16 rows and expert weights")
    n, d = x.shape
    e_count, i2, d2 = w_gate_up.shape
    if d2 != d or i2 % 2 or w_down.shape != (e_count, d, i2 // 2):
        raise ValueError(f"moe_experts: weights {tuple(w_gate_up.shape)}, {tuple(w_down.shape)} do not fit rows "
                         f"of {d}")
    if experts.shape != weights.shape or experts.dim() != 2 or experts.shape[0] != n:
        raise ValueError("moe_experts: experts and weights must be (N, k) for N rows")
    if d % BK_GATE_UP or (i2 // 2) % BN_GATE_UP or d % BN_DOWN or (i2 // 2) % BK_DOWN:
        raise ValueError(f"moe_experts: widths {d} and {i2 // 2} must be multiples of the kernels' tiles")
    if not (x.is_contiguous() and w_gate_up.is_contiguous() and w_down.is_contiguous()):
        raise ValueError("moe_experts: x and the expert weights must be contiguous")


def moe_experts(x, experts, weights, w_gate_up, w_down, stats=None) -> torch.Tensor:
    """sum over slots j of weights[:, j] * E_{experts[:, j]}(x), (N, D) in
    x's dtype. CPU tensors take the plain version; CUDA tensors launch the
    two Triton kernels or raise (also when an input requires grad: the
    kernels have no backward)."""
    if x.device.type == "cpu":
        return moe_experts_plain(x, experts, weights, w_gate_up, w_down, stats)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts: unsupported device {x.device}")
    refuse_grad("moe_experts", "CPU tensors (moe_experts_plain)", x, w_gate_up, w_down)
    _check(x, experts, weights, w_gate_up, w_down)
    n, d = x.shape
    e_count, i2, _ = w_gate_up.shape
    width, k = i2 // 2, experts.shape[1]
    order, offsets, counts = route_order(experts, e_count)
    h = torch.empty((n * k, width), dtype=x.dtype, device=x.device)
    out = torch.empty((n * k, d), dtype=torch.float32, device=x.device)
    flat_w = weights.reshape(-1).float().contiguous()
    bm = BM_WIDE if n * k >= WIDE_ROWS * e_count else BM  # from the shapes alone: the same at every routing
    ker = _build.triton("moe_experts")
    ker.fangyan_moe_gate_up[(e_count, width // BN_GATE_UP)](
        x, w_gate_up, order, offsets, h, d, width, k, BM=bm, BN=BN_GATE_UP, BK=BK_GATE_UP, num_warps=4, num_stages=4)
    launched("moe_experts")
    ker.fangyan_moe_down[(e_count, d // BN_DOWN)](
        h, w_down, order, offsets, flat_w, out, d, width, BM=bm, BN=BN_DOWN, BK=BK_DOWN, num_warps=4, num_stages=4)
    launched("moe_experts")
    _add_stats(stats, counts, n * k)
    return out.view(n, k, d).sum(dim=1).to(x.dtype)
