"""Carry the JAX package's parameters into the port's modules.

`llm_from_jax`, `flow_from_jax`, `hift_from_jax`, `campplus_from_jax`,
`s3_from_jax`, the CosyVoice1/2 carriers `llm_v2_from_jax`,
`llm_v1_from_jax`, `flow_v2_from_jax`, `flow_v1_from_jax` and
`hift_nc_from_jax`, and `discriminator_from_jax` take a param tree of the
JAX package (nested dicts of numpy arrays, as `jax.device_get` returns
them, or of torch tensors where train/checkpoint.py reads bfloat16) and
return the port's state_dict:

- the leading layer axis of the nn.scan stacks (`layers`, `blocks`,
  `encoders`, `up_encoders`, `mid`) is unstacked into `layers.{i}` etc.;
- a Dense kernel (in, out) becomes a Linear weight (out, in);
- a Conv kernel (K, Cin/g, Cout) becomes (Cout, Cin/g, K), and a
  `conv_transpose1d` kernel (K, Cout, Cin) (ops/convs.py of the JAX package)
  becomes torch's (Cin, Cout, K): both are the axis reversal; a 2-D
  `nn.Conv` kernel (kh, kw, Cin, Cout) becomes (Cout, Cin, kh, kw);
- flax WeightNorm's `WeightNorm_i/{"Conv_i/kernel/scale"}` becomes
  `Conv_i.scale` of the port's WNConv2d (models/discriminators.py);
- `embedding` becomes an Embedding's `weight`; `<name>_kernel` /
  `<name>_bias` leaves become `<name>.weight` / `<name>.bias`, and
  `<name>_scale` becomes `<name>.scale` (an AffineParams of
  models/conformer.py);
- the weight-only quantized leaves of ops/quant.py (`kernel_q` (in, out)
  int8, `kernel_q4` (in//2, out) int8, `scale`) keep their names and JAX
  layout: models built with `quant_int8` (`quant_int4_mlp`) hold them in
  QLinear (models/qwen2.py).

The result is checked against the port module's own keys and shapes: a
JAX leaf with no home, or a port parameter left without a value, raises.
Values keep their dtype; models are loaded with `load_state_dict(strict=True)`.
Quantized JAX trees (`quantize_qwen_params`, `quantize_dit_params`) go with
the quantized configuration's model: `llm_from_jax(qparams, cfg)` with
`cfg.qwen.quant_int8` set.

`to_jax_tree(state_dict, module)` is the inverse: the port's state_dict
back to the JAX package's nested tree (layers re-stacked, transposes
undone), so that the port writes model directories the JAX package reads
(train/checkpoint.save_params). A module whose type is exactly ConvParams,
or a bare nn.Module holding a weight, stands for the JAX module's
`<name>_kernel` / `<name>_bias` leaves, an AffineParams for
`<name>_scale` / `<name>_bias`, and a WNConv2d's scale goes back to its
WeightNorm_i entry.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..config import FlowConfig, HiFTConfig, LLMConfig
from .campplus import CAMPPlus
from .conformer import AffineParams
from .discriminators import MultipleDiscriminator, WNConv2d
from .dit import ConvParams
from .flow import CausalMaskedDiffWithDiT
from .flow_xvec import CausalMaskedDiffWithXvec, MaskedDiffWithXvec
from .hift import HiFT, CausalHiFT
from .llm import CosyVoice3LM, Qwen2LMV2
from .llm_v1 import TransformerLM
from .s3tokenizer import S3TokenizerV3

_STACKED = ("layers", "blocks", "encoders", "up_encoders", "mid")


def _to_torch(arr: np.ndarray | torch.Tensor) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.contiguous()
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16; go through float32 (exact)
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v if isinstance(v, torch.Tensor) else np.asarray(v)


def _permute(arr, axes: tuple[int, ...]):
    return arr.permute(*axes) if isinstance(arr, torch.Tensor) else arr.transpose(axes)


# kernel axes, JAX -> torch: Dense (in, out) -> Linear (out, in); conv
# (K, Cin/g, Cout) / transposed conv (K, Cout, Cin) -> axis reversal; 2-D conv
# (kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw)
_TO_TORCH = {1: (0,), 2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_TO_JAX = {1: (0,), 2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _leaf(path: tuple[str, ...], arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        mods, leaf = mods + ["weight"], None
    elif leaf.endswith("_kernel"):
        mods, leaf = mods + [leaf[: -len("_kernel")], "weight"], None
    elif leaf.endswith("_bias"):
        mods, leaf = mods + [leaf[: -len("_bias")], "bias"], None
    elif leaf.endswith("_scale"):
        return ".".join(mods + [leaf[: -len("_scale")], "scale"]), arr
    elif leaf == "embedding":
        return ".".join(mods + ["weight"]), arr
    else:
        return ".".join(mods + [leaf]), arr
    return ".".join(mods), _permute(arr, _TO_TORCH[arr.ndim])


def convert(params: Mapping[str, Any], module: nn.Module) -> dict[str, torch.Tensor]:
    """JAX param tree -> state_dict for `module` (keys and shapes checked)."""
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        stacked = [i for i, p in enumerate(path) if p in _STACKED]
        if stacked:
            s = stacked[0]
            items = [(path[: s + 1] + (str(i),) + path[s + 1 :], arr[i]) for i in range(arr.shape[0])]
        else:
            items = [(path, arr)]
        for p, a in items:
            name, a = _leaf(p, a)
            out[name] = _to_torch(a)
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    unused = sorted(set(out) - set(want))
    missing = sorted(set(want) - set(out))
    if unused or missing:
        raise ValueError(f"JAX params do not match {type(module).__name__}: unused {unused[:8]}, missing {missing[:8]}")
    bad = [k for k in want if tuple(out[k].shape) != want[k]]
    if bad:
        raise ValueError(f"shape mismatch for {bad[:8]}: " + ", ".join(
            f"{k} {tuple(out[k].shape)} vs {want[k]}" for k in bad[:8]))
    return out


def _skeleton(ctor):
    with torch.device("meta"):
        return ctor()


def llm_from_jax(params: Mapping[str, Any], cfg: LLMConfig) -> dict[str, torch.Tensor]:
    return convert(params, _skeleton(lambda: CosyVoice3LM(cfg)))


def flow_from_jax(params: Mapping[str, Any], cfg: FlowConfig) -> dict[str, torch.Tensor]:
    return convert(params, _skeleton(lambda: CausalMaskedDiffWithDiT(cfg)))


def hift_from_jax(params: Mapping[str, Any], cfg: HiFTConfig) -> dict[str, torch.Tensor]:
    return convert(params, _skeleton(lambda: CausalHiFT(cfg)))


def campplus_from_jax(params: Mapping[str, Any], **kwargs) -> dict[str, torch.Tensor]:
    """CAM++ tree -> state_dict; kwargs are CAMPPlus's (full size by default)."""
    return convert(params, _skeleton(lambda: CAMPPlus(**kwargs)))


def s3_from_jax(params: Mapping[str, Any], **kwargs) -> dict[str, torch.Tensor]:
    """S3 tokenizer tree -> state_dict; kwargs are S3TokenizerV3's."""
    return convert(params, _skeleton(lambda: S3TokenizerV3(**kwargs)))


def llm_v2_from_jax(params: Mapping[str, Any], cfg: LLMConfig) -> dict[str, torch.Tensor]:
    return convert(params, _skeleton(lambda: Qwen2LMV2(cfg)))


def llm_v1_from_jax(params: Mapping[str, Any], **kwargs) -> dict[str, torch.Tensor]:
    """TransformerLM tree -> state_dict; kwargs are TransformerLM's."""
    return convert(params, _skeleton(lambda: TransformerLM(**kwargs)))


def flow_v2_from_jax(params: Mapping[str, Any], **kwargs) -> dict[str, torch.Tensor]:
    """CausalMaskedDiffWithXvec tree -> state_dict; kwargs are its."""
    return convert(params, _skeleton(lambda: CausalMaskedDiffWithXvec(**kwargs)))


def flow_v1_from_jax(params: Mapping[str, Any], **kwargs) -> dict[str, torch.Tensor]:
    """MaskedDiffWithXvec tree -> state_dict; kwargs are its."""
    return convert(params, _skeleton(lambda: MaskedDiffWithXvec(**kwargs)))


def hift_nc_from_jax(params: Mapping[str, Any], cfg: HiFTConfig) -> dict[str, torch.Tensor]:
    """The non-causal HiFT (v1 / v2) tree -> state_dict."""
    return convert(params, _skeleton(lambda: HiFT(cfg)))


def discriminator_from_jax(params: Mapping[str, Any], **kwargs) -> dict[str, torch.Tensor]:
    """MultipleDiscriminator tree -> state_dict; kwargs are its (the full
    set of periods and resolutions by default). Each WeightNorm_i's scale
    moves beside the kernel of its Conv_i."""
    tree = {}
    for name, sub in params.items():
        sub = dict(sub)
        for wn in [k for k in sub if k.startswith("WeightNorm_")]:
            for key, scale in sub.pop(wn).items():
                conv = key.split("/")[0]
                sub[conv] = dict(sub[conv], scale=scale)
        tree[name] = sub
    return convert(tree, _skeleton(lambda: MultipleDiscriminator(**kwargs)))


def _jax_leaf(t: torch.Tensor) -> np.ndarray | torch.Tensor:
    """numpy where numpy has the dtype; a bfloat16 tensor stays a tensor."""
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def to_jax_tree(state_dict: Mapping[str, torch.Tensor], module: nn.Module) -> dict:
    """The port's state_dict of `module` -> the JAX package's nested tree."""
    owners = dict(module.named_modules())
    flat: dict[tuple[str, ...], torch.Tensor] = {}
    for key, t in state_dict.items():
        mod_path, _, leaf = key.rpartition(".")
        owner = owners[mod_path]
        parts = mod_path.split(".") if mod_path else []
        if isinstance(owner, nn.Embedding):
            path = parts + ["embedding"]
        elif isinstance(owner, AffineParams):
            path = parts[:-1] + [f"{parts[-1]}_{leaf}"]
        elif isinstance(owner, WNConv2d) and leaf == "scale":  # Conv_i's scale lives in WeightNorm_i
            path = parts[:-1] + [f"WeightNorm_{parts[-1].split('_')[-1]}", f"{parts[-1]}/kernel/scale"]
        elif type(owner) in (ConvParams, nn.Module) and leaf in ("weight", "bias"):
            path = parts[:-1] + [f"{parts[-1]}_{'kernel' if leaf == 'weight' else 'bias'}"]
            if leaf == "weight":
                t = t.permute(*_TO_JAX[t.dim()])
        elif leaf == "weight" and t.dim() >= 2:
            path = parts + ["kernel"]
            t = t.permute(*_TO_JAX[t.dim()])
        else:
            path = parts + [leaf]
        flat[tuple(path)] = t
    stacks: dict[tuple[str, ...], dict[int, torch.Tensor]] = {}
    tree: dict = {}
    for path, t in flat.items():
        s = next((i for i, p in enumerate(path) if p in _STACKED), None)
        if s is None:
            _put(tree, path, _jax_leaf(t))
        else:
            stacks.setdefault(path[: s + 1] + path[s + 2 :], {})[int(path[s + 1])] = t
    for path, by_layer in stacks.items():
        _put(tree, path, _jax_leaf(torch.stack([by_layer[i] for i in range(len(by_layer))])))
    return tree


def _put(tree: dict, path: tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value
