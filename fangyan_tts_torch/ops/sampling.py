"""Repetition-aware (RAS) nucleus sampling (fangyan_tts_tpu/ops/sampling.py).

Batched over rows and drawn from an explicit `torch.Generator`. As in the
JAX module, stop ids are excluded by masking their probability to zero and
renormalising (one draw, no resample loop), top-k is taken before the
nucleus cut, and both the nucleus draw and the full-distribution fallback
are drawn every step so that no step depends on a device-to-host read.
Categorical draws use the Gumbel-max form: argmax(logits + Gumbel noise).

`generator` is one `torch.Generator` for the whole batch, or a list of one
generator per row (the continuous batch of models/llm.decode_chunk_cont):
row r then draws its nucleus and fallback uniforms from its own generator
in the order a one-row call draws them, so that its tokens equal a solo
decode's with that generator, whatever the other rows do (the JAX package's
per-row PRNG keys). That costs two small draws a row a step.
"""

from __future__ import annotations

import torch


def _uniform(shape, generator: torch.Generator | list[torch.Generator] | None, device) -> torch.Tensor:
    """Uniforms of `shape` (rows first): from one generator, or row r's from
    generator[r]."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"sampling: {len(generator)} generators for {shape[0]} rows")
        return torch.cat([torch.rand((1, *shape[1:]), generator=g, device=device, dtype=torch.float32)
                          for g in generator])
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def _categorical(logits: torch.Tensor, generator: torch.Generator | list[torch.Generator] | None) -> torch.Tensor:
    """One draw per row from softmax(logits) (rows on the last axis)."""
    u = _uniform(logits.shape, generator, logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)).clamp_min(1e-20))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def nucleus_pick(
    probs: torch.Tensor,
    generator: torch.Generator | list[torch.Generator] | None,
    top_p: float = 0.8,
    top_k: int = 25,
) -> torch.Tensor:
    """probs (B, V) -> (B,) ids drawn from the top-p ∧ top-k nucleus."""
    vals, idx = torch.topk(probs, min(top_k, probs.shape[-1]), dim=-1)
    # keep element i while the cumulative prob of the elements before it < top_p
    cum_excl = torch.cumsum(vals, dim=-1) - vals
    masked = torch.where(cum_excl < top_p, vals, torch.zeros_like(vals))
    choice = _categorical(torch.log(masked.clamp_min(1e-30)), generator)
    return torch.gather(idx, -1, choice[:, None])[:, 0]


def ras_sample(
    logp: torch.Tensor,
    recent_tokens: torch.Tensor,
    recent_valid: torch.Tensor,
    allowed_mask: torch.Tensor,
    generator: torch.Generator | list[torch.Generator] | None,
    top_p: float = 0.8,
    top_k: int = 25,
    win_size: int = 10,
    tau_r: float = 0.1,
) -> torch.Tensor:
    """One RAS step for every row.

    logp: (B, V) log-probabilities; recent_tokens / recent_valid: (B, win)
    window of the last emitted ids; allowed_mask: (B, V) bool, False ids get
    probability zero. Returns (B,) int32 ids.
    """
    probs = torch.softmax(logp, dim=-1)
    probs = torch.where(allowed_mask, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)

    cand = nucleus_pick(probs, generator, top_p=top_p, top_k=top_k)
    rep_num = ((recent_tokens == cand[:, None]) & recent_valid).sum(dim=-1)
    fallback = _categorical(torch.log(probs.clamp_min(1e-30)), generator)
    return torch.where(rep_num >= win_size * tau_r, fallback, cand).to(torch.int32)
