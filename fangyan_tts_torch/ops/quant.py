"""Weight-only int8 / int4 quantization (fangyan_tts_tpu/ops/quant.py).

Symmetric per-output-channel quantization of matmul kernels in the JAX
layout (in, out): q = round(w / s), s = max|w| / 127 (int8) or / 7 (int4)
over the input axis, computed in float32 with round-half-to-even, so the
ints and scales are bit-equal to the JAX package's on the same weights.
int4 values are nibble-packed along the input axis: packed row i holds
input row 2i in the low nibble and row 2i+1 in the high nibble, two's
complement in [-7, 7].

`int8_dot` stays plain PyTorch, as the JAX package leaves it to XLA. The
int4 product goes through the kernel in ops/int4_matmul.py, whose plain
version is `int4_dot` here. Both plain products multiply in x's dtype and
apply the float32 scale to the result before the cast back: in float32
that is the JAX functions' arithmetic exactly; in bf16 the product is
rounded to bf16 once before the scale (the JAX package accumulates into
float32 and rounds once, after the scale, as the int4 kernel does).

`quantize_qwen_state` and `quantize_dit_state` rewrite the port's own
state_dicts as the JAX package's `quantize_qwen_params` and
`quantize_dit_params` rewrite its trees, keeping the JAX leaf names:
`<dense>.kernel_q` (in, out) int8 or `<dense>.kernel_q4` (in//2, out) int8,
`<dense>.scale` (out,) float32 and the bias as it was.
"""

from __future__ import annotations

import torch

QWEN_DENSE_NAMES = frozenset({"qkv_proj", "o_proj", "gate_up_proj", "down_proj"})
QWEN_MLP_NAMES = frozenset({"gate_up_proj", "down_proj"})
DIT_DENSE_NAMES = frozenset({"to_qkv", "to_out", "attn_norm_linear", "ff_0", "ff_2"})


def quantize_int8(w: torch.Tensor, axis: int = -2) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 over the input `axis`: (q int8 like w,
    scale float32 with `axis` dropped)."""
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def quantize_int4_packed(w: torch.Tensor, axis: int = -2) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int4 in [-7, 7], nibble-packed two a byte along
    the input `axis` (which must be even): (packed int8 with that axis
    halved, scale float32 with it dropped)."""
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(w / scale), -7, 7).to(torch.int32).movedim(axis, -2)
    pair = q.reshape(*q.shape[:-2], q.shape[-2] // 2, 2, q.shape[-1])
    lo, hi = pair[..., 0, :], pair[..., 1, :]
    packed = ((hi << 4) | (lo & 0x0F)).to(torch.int8).movedim(-2, axis)
    return packed.contiguous(), scale.squeeze(axis)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """(…, in//2, out) packed int8 -> (…, in, out) int32 values in [-7, 7]
    (sign-extended nibbles, low = even input rows)."""
    w = w_packed.to(torch.int32)
    lo = (w << 28) >> 28
    hi = w >> 4
    return torch.stack([lo, hi], dim=-2).reshape(*w.shape[:-2], 2 * w.shape[-2], w.shape[-1])


def int8_dot(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (…, in) @ w_q (in, out) int8 with per-output-channel float32
    `scale` (out,); result in x's dtype."""
    y = torch.matmul(x, w_q.to(x.dtype))
    return (y.float() * scale).to(x.dtype)


def int4_dot(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (…, in) @ nibble-packed int4 (in//2, out) with per-output-channel
    float32 `scale`; result in x's dtype."""
    y = torch.matmul(x, unpack_int4(w_packed).to(x.dtype))
    return (y.float() * scale).to(x.dtype)


def _rewrite(sd: dict, pick) -> dict:
    """Replace each `<prefix>.<name>.weight` (torch (out, in)) for which
    pick(key, name) gives 8 or 4 by the JAX package's quantized leaves."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        bits = pick(k, parts[-2]) if len(parts) >= 2 and parts[-1] == "weight" and v.dim() == 2 else 0
        if not bits:
            out[k] = v
            continue
        prefix = k[: -len("weight")]
        w = v.t()  # JAX layout (in, out)
        if bits == 4:
            out[prefix + "kernel_q4"], out[prefix + "scale"] = quantize_int4_packed(w)
        else:
            q, out[prefix + "scale"] = quantize_int8(w)
            out[prefix + "kernel_q"] = q.contiguous()
    return out


def quantize_qwen_state(sd: dict, int4_mlp: bool = False) -> dict:
    """The LLM's state_dict with every transformer-block dense kernel in
    int8 (the MLP's in int4 with `int4_mlp`); biases, norms, embeddings and
    the llm_decoder head unchanged."""
    return _rewrite(sd, lambda k, name: (4 if int4_mlp and name in QWEN_MLP_NAMES else 8)
                    if name in QWEN_DENSE_NAMES else 0)


def quantize_dit_state(sd: dict) -> dict:
    """The flow's state_dict with the DiT estimator's per-block dense
    kernels (qkv, out, AdaLN modulation, feed-forward) in int8; everything
    else unchanged."""
    return _rewrite(sd, lambda k, name: 8 if k.startswith("estimator.") and name in DIT_DENSE_NAMES else 0)
