"""Carry the JAX package's parameters into the port's modules.

`llm_from_jax`, `flow_from_jax` and `hift_from_jax` take a param tree of
the JAX package (nested dicts of numpy arrays, as `jax.device_get` returns
them) and return the port's state_dict:

- the leading layer axis of `layers` / `blocks` (nn.scan) is unstacked
  into `layers.{i}` / `blocks.{i}`;
- a Dense kernel (in, out) becomes a Linear weight (out, in);
- a Conv kernel (K, Cin/g, Cout) becomes (Cout, Cin/g, K), and a
  `conv_transpose1d` kernel (K, Cout, Cin) (ops/convs.py of the JAX package)
  becomes torch's (Cin, Cout, K): both are the axis reversal;
- `embedding` becomes an Embedding's `weight`; `<name>_kernel` /
  `<name>_bias` leaves become `<name>.weight` / `<name>.bias`.

The result is checked against the port module's own keys and shapes: a
JAX leaf with no home, or a port parameter left without a value, raises.
Values keep their dtype; models are loaded with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..config import FlowConfig, HiFTConfig, LLMConfig
from .flow import CausalMaskedDiffWithDiT
from .hift import CausalHiFT
from .llm import CosyVoice3LM

_STACKED = ("layers", "blocks")


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16; go through float32 (exact)
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _leaf(path: tuple[str, ...], arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        mods, leaf = mods + ["weight"], None
    elif leaf.endswith("_kernel"):
        mods, leaf = mods + [leaf[: -len("_kernel")], "weight"], None
    elif leaf.endswith("_bias"):
        mods, leaf = mods + [leaf[: -len("_bias")], "bias"], None
    elif leaf == "embedding":
        return ".".join(mods + ["weight"]), arr
    else:
        return ".".join(mods + [leaf]), arr
    if arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        arr = arr.T
    elif arr.ndim == 3:  # (K, Cin/g, Cout) / (K, Cout, Cin) -> axis reversal
        arr = arr.transpose(2, 1, 0)
    return ".".join(mods), arr


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
