"""Padding and chunk-causal attention masks (fangyan_tts_tpu/ops/masks.py).

Same semantics as the JAX module: boolean masks that are True where a key
may be attended, and `mask_to_bias`'s finite -1e10 instead of -inf, which
keeps softmax finite on rows with no valid key.
"""

from __future__ import annotations

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True where padded. lengths: (B,) int; returns (B, max_len) bool."""
    pos = torch.arange(max_len, device=lengths.device, dtype=torch.int32)[None, :]
    return pos >= lengths.to(torch.int32)[:, None]


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True where valid (non-padded)."""
    return ~make_pad_mask(lengths, max_len)


def subsequent_chunk_mask(size: int, chunk_size: int, device=None) -> torch.Tensor:
    """(size, size) bool: row i attends keys before the end of its chunk."""
    pos = torch.arange(size, device=device, dtype=torch.int32)
    block_end = (pos // chunk_size + 1) * chunk_size
    return pos[None, :] < block_end[:, None]


def chunk_attn_mask(lengths: torch.Tensor, max_len: int, chunk_size: int) -> torch.Tensor:
    """(B, max_len, max_len) bool: key padding, plus static chunk causality
    when chunk_size > 0 (unlimited left context, chunk-causal right edge)."""
    pad = make_non_pad_mask(lengths, max_len)[:, None, :]
    if chunk_size and chunk_size > 0:
        return pad & subsequent_chunk_mask(max_len, chunk_size, lengths.device)[None]
    return pad.expand(pad.shape[0], max_len, max_len)


def mask_to_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """bool mask -> additive bias: 0 where allowed, -1e10 where not."""
    return (1.0 - mask.to(dtype)) * -1.0e10


def chunk_kv_bias(lens: torch.Tensor, q_valid: torch.Tensor, lq: int, cap: int, chunk_size: int) -> torch.Tensor:
    """(B, lq, cap) additive float32 bias for KV-cached chunk attention:
    the query at absolute position lens + j attends the keys [0, min(end of
    its own chunk, lens + q_valid)), chunk_attn_mask's allowed set at the
    stream front, restricted to the new rows. Keys are addressed by
    absolute position (the cache grows contiguously from 0)."""
    abs_q = lens[:, None] + torch.arange(lq, device=lens.device)[None, :]
    front = (lens + q_valid)[:, None]
    cap_q = torch.minimum((abs_q // chunk_size + 1) * chunk_size, front)
    key_pos = torch.arange(cap, device=lens.device)[None, None, :]
    return mask_to_bias(key_pos < cap_q[:, :, None])


def chunk_split_bias(lens: torch.Tensor, q_valid: torch.Tensor, lq: int, cap: int,
                     chunk_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(bias_cache (B, lq, cap), bias_new (B, lq, lq)): chunk_kv_bias's
    allowed set split between the read-only cache and the hop's own frames.
    Cached keys [0, lens) lie in chunks no later than any valid query's
    (hops are chunk-aligned), so bias_cache only masks empty slots;
    bias_new applies the chunk-causal and q_valid rule among the hop's
    frames at absolute positions lens + i."""
    abs_q = lens[:, None] + torch.arange(lq, device=lens.device)[None, :]
    front = (lens + q_valid)[:, None]
    cap_q = torch.minimum((abs_q // chunk_size + 1) * chunk_size, front)
    key_pos = torch.arange(cap, device=lens.device)[None, None, :]
    bias_cache = mask_to_bias(key_pos < torch.minimum(cap_q, lens[:, None])[:, :, None])
    bias_new = mask_to_bias(abs_q[:, None, :] < cap_q[:, :, None])
    return bias_cache, bias_new


def causal_mask(size: int, device=None) -> torch.Tensor:
    """(size, size) lower-triangular bool mask."""
    pos = torch.arange(size, device=device)
    return pos[None, :] <= pos[:, None]
