"""Torch state_dicts of the reference checkpoints -> the JAX package's
parameter trees (the port's copy of the pure-numpy converters of
fangyan_tts_tpu/models/convert.py that the API and the frontend need).

- `llm_params_from_reference`, `flow_params_from_reference` (with
  `dit_estimator_params`) and `hift_params_from_reference` map llm.pt,
  flow.pt and hift.pt; `fuse_qwen_split_params` upgrades a tree saved with
  split q/k/v and gate/up kernels; `filter_training_meta` drops the
  epoch/step scalars of a training checkpoint;
- `campplus_params_from_torch` and `s3_params_from_torch` map the CAM++ and
  S3 tokenizer state dicts, and `campplus_params_from_onnx` /
  `s3_params_from_onnx` the same weights read from the reference's
  campplus.onnx / speech_tokenizer_v3.onnx (data/onnx_proto.py);
- the CosyVoice1/2 converters: `llm_v1_params_from_reference`,
  `llm_v2_params_from_reference`, `flow_v1_params_from_reference`,
  `flow_v2_params_from_reference` and `hift_nc_params_from_reference`, on
  the conformer, U-Net and BatchNorm-fold helpers.

The trees are nested dicts of numpy arrays, in the JAX package's layout;
models/from_jax.py carries them into the port's modules.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _stack_trees(trees: list) -> Any:
    """Per-layer trees of one structure -> one tree with a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees, axis=0)


def _t(x) -> np.ndarray:
    """torch tensor / array -> float32 numpy (transposed handled by caller)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def qwen2_params_from_hf(state_dict: Mapping[str, Any], num_layers: int, prefix: str = "model.") -> dict:
    """HF Qwen2ForCausalLM state_dict -> Qwen2Model params dict.

    `prefix` is the key prefix up to the decoder stack ('model.' for a bare
    Qwen2ForCausalLM; 'llm.model.model.' inside a CosyVoice3 llm.pt).
    Linear weights are transposed (torch stores (out, in); flax Dense kernels
    are (in, out)).
    """
    layers: list[dict] = []
    for i in range(num_layers):
        lp = f"{prefix}layers.{i}."
        layer = {
            "input_layernorm": {"weight": _t(state_dict[lp + "input_layernorm.weight"])},
            "post_attention_layernorm": {"weight": _t(state_dict[lp + "post_attention_layernorm.weight"])},
            "self_attn": {},
            "mlp": {},
        }
        # q/k/v and gate/up are stored FUSED (single matmul per group at
        # decode — see qwen2.Qwen2Attention); concat the HF split weights
        qkv_w = np.concatenate(
            [_t(state_dict[lp + f"self_attn.{n}.weight"]).T for n in ("q_proj", "k_proj", "v_proj")],
            axis=1,
        )
        layer["self_attn"]["qkv_proj"] = {"kernel": qkv_w}
        if lp + "self_attn.q_proj.bias" in state_dict:
            layer["self_attn"]["qkv_proj"]["bias"] = np.concatenate(
                [_t(state_dict[lp + f"self_attn.{n}.bias"]) for n in ("q_proj", "k_proj", "v_proj")]
            )
        layer["self_attn"]["o_proj"] = {"kernel": _t(state_dict[lp + "self_attn.o_proj.weight"]).T}
        layer["mlp"]["gate_up_proj"] = {
            "kernel": np.concatenate(
                [_t(state_dict[lp + f"mlp.{n}.weight"]).T for n in ("gate_proj", "up_proj")], axis=1
            )
        }
        layer["mlp"]["down_proj"] = {"kernel": _t(state_dict[lp + "mlp.down_proj.weight"]).T}
        layers.append(layer)
    # stack per-layer trees along a leading layer axis (Qwen2Model nn.scan layout)
    stacked = _stack_trees(layers)
    return {"layers": stacked, "norm": {"weight": _t(state_dict[prefix + "norm.weight"])}}


def fuse_qwen_split_params(tree: Any) -> Any:
    """Upgrade a params pytree saved with split q/k/v (and gate/up) Dense
    layouts to the fused qkv_proj / gate_up_proj layout. No-op on already
    fused trees; works on stacked (L, in, out) scan layouts too."""

    def cat(parts, axis=-1):
        if hasattr(parts[0], "detach"):  # torch leaves (a bfloat16 checkpoint, train/checkpoint.py)
            import torch

            return torch.cat(list(parts), dim=axis)
        return np.concatenate([np.asarray(p) for p in parts], axis=axis)

    def walk(t: Any) -> Any:
        if not isinstance(t, dict):
            return t
        t = {k: walk(v) for k, v in t.items()}
        if {"q_proj", "k_proj", "v_proj"} <= set(t):
            fused = {"kernel": cat([t[n]["kernel"] for n in ("q_proj", "k_proj", "v_proj")])}
            if "bias" in t["q_proj"]:
                fused["bias"] = cat([t[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")])
            t = {k: v for k, v in t.items() if k not in ("q_proj", "k_proj", "v_proj")}
            t["qkv_proj"] = fused
        if {"gate_proj", "up_proj"} <= set(t):
            t["gate_up_proj"] = {"kernel": cat([t["gate_proj"]["kernel"], t["up_proj"]["kernel"]])}
            t = {k: v for k, v in t.items() if k not in ("gate_proj", "up_proj")}
        return t

    return walk(tree)


def _fold_weight_norm(sd: Mapping[str, Any], base: str) -> np.ndarray:
    """Fold torch weight_norm into a plain weight. Handles both the modern
    parametrizations layout (original0=g, original1=v) and legacy
    weight_g/weight_v; falls back to a plain `.weight`."""
    for g_key, v_key in (
        (base + ".parametrizations.weight.original0", base + ".parametrizations.weight.original1"),
        (base + ".weight_g", base + ".weight_v"),
    ):
        if g_key in sd:
            g = _t(sd[g_key]).astype(np.float64)
            v = _t(sd[v_key]).astype(np.float64)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
            return (g * v / np.maximum(norm, 1e-12)).astype(np.float32)
    return _t(sd[base + ".weight"])


def _conv_w(sd, base) -> np.ndarray:
    """torch Conv1d weight (out, in/groups, k) -> flax (k, in/groups, out)."""
    return _fold_weight_norm(sd, base).transpose(2, 1, 0)


def _lin(sd, base) -> dict:
    out = {"kernel": _fold_weight_norm(sd, base).T}
    if base + ".bias" in sd:
        out["bias"] = _t(sd[base + ".bias"])
    return out


def _conv(sd, base) -> dict:
    out = {"kernel": _conv_w(sd, base)}
    if base + ".bias" in sd:
        out["bias"] = _t(sd[base + ".bias"])
    return out


def llm_params_from_reference(sd: Mapping[str, Any], num_layers: int = 24) -> dict:
    """CosyVoice llm.pt -> CosyVoice3LM params.

    Reference layout (llm.py:628-668): llm.model.* is the HF Qwen2ForCausalLM
    (Qwen2Encoder wrapper, llm.py:230-233); speech_embedding and llm_decoder
    sit beside it. epoch/step metadata keys are ignored
    (compare_inference.py:36-44 does the same filtering)."""
    p = {
        "embed_tokens": {"embedding": _t(sd["llm.model.model.embed_tokens.weight"])},
        "speech_embedding": {"embedding": _t(sd["speech_embedding.weight"])},
        "llm_decoder": {"kernel": _t(sd["llm_decoder.weight"]).T},
        "llm": qwen2_params_from_hf(sd, num_layers, prefix="llm.model.model."),
    }
    return p


def flow_params_from_reference(sd: Mapping[str, Any], depth: int = 22) -> dict:
    """CosyVoice flow.pt -> CausalMaskedDiffWithDiT params.

    Mapping notes (torch module paths from flow.py:278-310, DiT/dit.py:104-143,
    DiT/modules.py):
    - AdaLN chunk orders match (shift/scale/gate msa, shift/scale/gate mlp;
      final layer: scale then shift) — verified against modules.py:241,262.
    - the rotary quirk needs no weights (models/dit.py reproduces it in code).
    """
    p: dict = {
        "input_embedding": {"embedding": _t(sd["input_embedding.weight"])},
        "spk_embed_affine_layer": _lin(sd, "spk_embed_affine_layer"),
        "pre_lookahead_layer": {
            "conv1_kernel": _conv_w(sd, "pre_lookahead_layer.conv1"),
            "conv1_bias": _t(sd["pre_lookahead_layer.conv1.bias"]),
            "conv2_kernel": _conv_w(sd, "pre_lookahead_layer.conv2"),
            "conv2_bias": _t(sd["pre_lookahead_layer.conv2.bias"]),
        },
        "estimator": dit_estimator_params(sd, "decoder.estimator.", depth),
    }
    return p


def dit_estimator_params(sd: Mapping[str, Any], prefix: str, depth: int) -> dict:
    """Reference DiT (flow/DiT/dit.py:104-176) -> models/dit.py DiT params.
    `prefix` is '' for a raw DiT state dict, 'decoder.estimator.' inside
    flow.pt."""
    est = prefix
    p: dict = {
        "time_embed": {
            "mlp_0": _lin(sd, est + "time_embed.time_mlp.0"),
            "mlp_2": _lin(sd, est + "time_embed.time_mlp.2"),
        },
        "input_proj": _lin(sd, est + "input_embed.proj"),
        "conv_pos_embed": {
            "conv1_kernel": _conv_w(sd, est + "input_embed.conv_pos_embed.conv1.0"),
            "conv1_bias": _t(sd[est + "input_embed.conv_pos_embed.conv1.0.bias"]),
            "conv2_kernel": _conv_w(sd, est + "input_embed.conv_pos_embed.conv2.0"),
            "conv2_bias": _t(sd[est + "input_embed.conv_pos_embed.conv2.0.bias"]),
        },
        "norm_out_linear": _lin(sd, est + "norm_out.linear"),
        "proj_out": _lin(sd, est + "proj_out"),
    }
    blocks = []
    for i in range(depth):
        b = f"{est}transformer_blocks.{i}."
        blocks.append(
            {
                "attn_norm_linear": _lin(sd, b + "attn_norm.linear"),
                "attn": {
                    # fused qkv kernel (models/dit.py DiTAttention): the
                    # reference's separate to_q/to_k/to_v concatenate on the
                    # output axis
                    "to_qkv": {
                        "kernel": np.concatenate(
                            [_lin(sd, b + f"attn.to_{n}")["kernel"] for n in "qkv"], axis=1
                        ),
                        "bias": np.concatenate(
                            [_lin(sd, b + f"attn.to_{n}")["bias"] for n in "qkv"]
                        ),
                    },
                    "to_out": _lin(sd, b + "attn.to_out.0"),
                },
                "ff_0": _lin(sd, b + "ff.ff.0.0"),
                "ff_2": _lin(sd, b + "ff.ff.2"),
            }
        )
    p["blocks"] = _stack_trees(blocks)
    return p


def hift_params_from_reference(
    sd: Mapping[str, Any],
    upsample_rates: tuple = (8, 5, 3),
    num_resblock_kernels: int = 3,
    resblock_dilations: int = 3,
) -> dict:
    """CosyVoice hift.pt -> CausalHiFT params (generator.py:572-726 layout,
    weight_norm folded)."""
    p: dict = {
        "conv_pre": _conv(sd, "conv_pre"),
        "conv_post": _conv(sd, "conv_post"),
        "m_source": {"l_linear": _lin(sd, "m_source.l_linear")},
        "f0_predictor": {"classifier": _lin(sd, "f0_predictor.classifier")},
    }
    for i in range(5):
        p["f0_predictor"][f"conv{i}"] = _conv(sd, f"f0_predictor.condnet.{2 * i}")
    for i in range(len(upsample_rates)):
        p[f"ups_{i}"] = _conv(sd, f"ups.{i}")
        p[f"source_downs_{i}"] = _conv(sd, f"source_downs.{i}")
        p[f"source_resblocks_{i}"] = _resblock(sd, f"source_resblocks.{i}", resblock_dilations)
        for j in range(num_resblock_kernels):
            p[f"resblocks_{i}_{j}"] = _resblock(sd, f"resblocks.{i * num_resblock_kernels + j}", resblock_dilations)
    return p


def _resblock(sd, base, n_dil: int) -> dict:
    out: dict = {}
    for j in range(n_dil):
        out[f"convs1_{j}"] = _conv(sd, f"{base}.convs1.{j}")
        out[f"convs2_{j}"] = _conv(sd, f"{base}.convs2.{j}")
        out[f"alpha1_{j}"] = _t(sd[f"{base}.activations1.{j}.alpha"])
        out[f"alpha2_{j}"] = _t(sd[f"{base}.activations2.{j}.alpha"])
    return out


def filter_training_meta(sd: Mapping[str, Any]) -> dict:
    """Drop epoch/step scalars from a reference training checkpoint
    (compare_inference.py:36-40)."""
    return {k: v for k, v in sd.items() if k not in ("epoch", "step")}


# ------------------------------------------------------------- CAM++ frontend


def _bn(sd, base, affine: bool = True) -> dict:
    out = {"mean": _t(sd[base + ".running_mean"]), "var": _t(sd[base + ".running_var"])}
    if affine:
        out["scale"] = _t(sd[base + ".weight"])
        out["bias"] = _t(sd[base + ".bias"])
    return out


def _conv2d(sd, base) -> dict:
    # torch Conv2d (O, I, H, W) -> flax (H, W, I, O)
    out = {"kernel": _fold_weight_norm(sd, base).transpose(2, 3, 1, 0)}
    if base + ".bias" in sd:
        out["bias"] = _t(sd[base + ".bias"])
    return out


def _lin_from_conv1x1(sd, base) -> dict:
    # torch Conv1d k=1 (O, I, 1) -> flax Dense (I, O)
    out = {"kernel": _t(sd[base + ".weight"])[:, :, 0].T}
    if base + ".bias" in sd:
        out["bias"] = _t(sd[base + ".bias"])
    return out


def campplus_params_from_torch(sd: Mapping[str, Any], block_layers=(12, 24, 16)) -> dict:
    """3D-Speaker CAMPPlus state dict (the campplus.onnx export source,
    frontend.py:45) -> models/campplus.py CAMPPlus params.

    Torch module names: head.{conv1,bn1,layer1.*,layer2.*,conv2,bn2},
    xvector.{tdnn,blockN.tdnndM.*,transitN,out_nonlinear,stats,dense}."""
    head: dict = {
        "conv1": _conv2d(sd, "head.conv1"),
        "bn1": _bn(sd, "head.bn1"),
        "conv2": _conv2d(sd, "head.conv2"),
        "bn2": _bn(sd, "head.bn2"),
    }
    for li in (1, 2):
        for bi in (0, 1):
            base = f"head.layer{li}.{bi}"
            blk = {
                "conv1": _conv2d(sd, base + ".conv1"),
                "bn1": _bn(sd, base + ".bn1"),
                "conv2": _conv2d(sd, base + ".conv2"),
                "bn2": _bn(sd, base + ".bn2"),
            }
            if base + ".shortcut.0.weight" in sd:
                blk["shortcut_conv"] = _conv2d(sd, base + ".shortcut.0")
                blk["shortcut_bn"] = _bn(sd, base + ".shortcut.1")
            head[f"layer{li}_{bi}"] = blk

    p: dict = {
        "head": head,
        "tdnn": {
            "kernel": _conv_w(sd, "xvector.tdnn.linear"),
            "bn": _bn(sd, "xvector.tdnn.nonlinear.batchnorm"),
        },
    }
    for b, nl in enumerate(block_layers):
        blk = {}
        for i in range(nl):
            base = f"xvector.block{b + 1}.tdnnd{i + 1}"
            blk[f"layer_{i}"] = {
                "bn1": _bn(sd, base + ".nonlinear1.batchnorm"),
                "linear1": _lin_from_conv1x1(sd, base + ".linear1"),
                "bn2": _bn(sd, base + ".nonlinear2.batchnorm"),
                "cam_layer": {
                    "linear_local_kernel": _conv_w(sd, base + ".cam_layer.linear_local"),
                    "linear1": _lin_from_conv1x1(sd, base + ".cam_layer.linear1"),
                    "linear2": _lin_from_conv1x1(sd, base + ".cam_layer.linear2"),
                },
            }
        p[f"block_{b}"] = blk
        p[f"transit_{b}"] = {
            "bn": _bn(sd, f"xvector.transit{b + 1}.nonlinear.batchnorm"),
            "linear": _lin_from_conv1x1(sd, f"xvector.transit{b + 1}.linear"),
        }
    p["out_bn"] = _bn(sd, "xvector.out_nonlinear.batchnorm")
    p["embedding"] = _lin_from_conv1x1(sd, "xvector.dense.linear")
    p["emb_bn"] = _bn(sd, "xvector.dense.nonlinear.batchnorm", affine=False)
    return p


def campplus_params_from_onnx(path, block_layers=(12, 24, 16)) -> dict:
    """campplus.onnx -> CAMPPlus params (tools/extract_embedding.py:36-41).

    Torch ONNX exports keep state-dict names for initializers when BN is not
    constant-folded; folded graphs rename them onnx::Conv_*, and are refused."""
    from ..data.onnx_proto import load_graph

    sd = load_graph(path).weights()
    if "xvector.tdnn.linear.weight" not in sd:
        raise ValueError(
            "campplus.onnx initializers are not state-dict-named (likely a "
            "constant-folded export); export it without constant folding"
        )
    # architecture check against the graph: the dense layers' conv1x1 bottlenecks
    n_tdnnd = sum(1 for k in sd if ".linear1.weight" in k and ".cam_layer" not in k)
    if n_tdnnd != sum(block_layers):
        raise ValueError(f"graph has {n_tdnnd} dense layers, expected {sum(block_layers)}")
    return campplus_params_from_torch(sd, block_layers)


# ------------------------------------------------------- S3 tokenizer frontend


def s3_params_from_torch(sd: Mapping[str, Any]) -> tuple[dict, dict]:
    """S3Tokenizer v2/v3 state dict (the speech_tokenizer ONNX export source,
    frontend.py:46-48) -> (models/s3tokenizer.py params, derived hyperparams).

    Hyperparameters (dim/heads inferable/layers/fsmn kernel) are DERIVED from
    the weights rather than trusted: layer count from block indices, dim and
    n_mels from conv1, fsmn kernel width from the depthwise conv."""
    layers = 0
    while f"encoder.blocks.{layers}.attn.query.weight" in sd:
        layers += 1
    if layers == 0:
        raise ValueError("no encoder.blocks.* in state dict — not an S3 tokenizer export?")
    w1 = _t(sd["encoder.conv1.weight"])  # (D, n_mels, 3)
    dim, n_mels = int(w1.shape[0]), int(w1.shape[1])
    fsmn_k = int(_t(sd["encoder.blocks.0.attn.fsmn_block.weight"]).shape[2])

    pd_base = (
        "quantizer._codebook.project_down"
        if "quantizer._codebook.project_down.weight" in sd
        else "quantizer.project_down"
    )
    p: dict = {
        "conv1_kernel": _conv_w(sd, "encoder.conv1"),
        "conv1_bias": _t(sd["encoder.conv1.bias"]),
        "conv2_kernel": _conv_w(sd, "encoder.conv2"),
        "conv2_bias": _t(sd["encoder.conv2.bias"]),
        "fsq": {"project_down": _lin(sd, pd_base)},
    }
    for i in range(layers):
        base = f"encoder.blocks.{i}"
        p[f"blocks_{i}"] = {
            "attn_ln": {"scale": _t(sd[f"{base}.attn_ln.weight"]), "bias": _t(sd[f"{base}.attn_ln.bias"])},
            "q": _lin(sd, f"{base}.attn.query"),
            "k": _lin(sd, f"{base}.attn.key"),
            "v": _lin(sd, f"{base}.attn.value"),
            "out": _lin(sd, f"{base}.attn.out"),
            "fsmn_kernel": _conv_w(sd, f"{base}.attn.fsmn_block"),
            "mlp_ln": {"scale": _t(sd[f"{base}.mlp_ln.weight"]), "bias": _t(sd[f"{base}.mlp_ln.bias"])},
            "mlp_0": _lin(sd, f"{base}.mlp.0"),
            "mlp_2": _lin(sd, f"{base}.mlp.2"),
        }
    hyper = {"dim": dim, "n_mels": n_mels, "layers": layers, "fsmn_kernel": fsmn_k}
    return p, hyper


def s3_params_from_onnx(path) -> tuple[dict, dict]:
    """speech_tokenizer_v3.onnx -> (params, derived hyperparams)
    (tools/extract_speech_token.py:38-48). Requires a state-dict-named
    export; folded / renamed graphs are refused."""
    from ..data.onnx_proto import load_graph

    sd = load_graph(path).weights()
    if "encoder.conv1.weight" not in sd:
        raise ValueError(
            "speech tokenizer ONNX initializers are not state-dict-named "
            "(likely a constant-folded export); export it without constant folding"
        )
    return s3_params_from_torch(sd)


# --------------------------------------------- CosyVoice1/2 families


def _fold_bn_affine(sd, base, eps: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    """BatchNorm1d (eval) -> (scale, bias) affine fold."""
    w = _t(sd[base + ".weight"])
    b = _t(sd[base + ".bias"])
    mean = _t(sd[base + ".running_mean"])
    var = _t(sd[base + ".running_var"])
    scale = w / np.sqrt(var + eps)
    return scale, b - mean * scale


def _conformer_layer_params(sd, base, macaron: bool, use_cnn: bool, cnn_norm: str = "batch_norm", transformer: bool = False) -> dict:
    """One (Conformer/Transformer)EncoderLayer (encoder_layer.py:40-236) ->
    our ConformerEncoderLayer params. TransformerEncoderLayer names its
    norms norm1/norm2 (encoder_layer.py:52-53) instead of norm_mha/norm_ff."""
    n_mha, n_ff = ("norm1", "norm2") if transformer else ("norm_mha", "norm_ff")
    p: dict = {
        "self_attn": {
            "linear_q": _lin(sd, base + ".self_attn.linear_q"),
            "linear_k": _lin(sd, base + ".self_attn.linear_k"),
            "linear_v": _lin(sd, base + ".self_attn.linear_v"),
            "linear_out": _lin(sd, base + ".self_attn.linear_out"),
            "linear_pos": {"kernel": _t(sd[base + ".self_attn.linear_pos.weight"]).T},
            "pos_bias_u": _t(sd[base + ".self_attn.pos_bias_u"]),
            "pos_bias_v": _t(sd[base + ".self_attn.pos_bias_v"]),
        },
        "ff": {
            "w_1": _lin(sd, base + ".feed_forward.w_1"),
            "w_2": _lin(sd, base + ".feed_forward.w_2"),
        },
        "norm_mha": {"scale": _t(sd[f"{base}.{n_mha}.weight"]), "bias": _t(sd[f"{base}.{n_mha}.bias"])},
        "norm_ff": {"scale": _t(sd[f"{base}.{n_ff}.weight"]), "bias": _t(sd[f"{base}.{n_ff}.bias"])},
    }
    if macaron:
        p["ff_macaron"] = {
            "w_1": _lin(sd, base + ".feed_forward_macaron.w_1"),
            "w_2": _lin(sd, base + ".feed_forward_macaron.w_2"),
        }
        p["norm_ff_macaron"] = {
            "scale": _t(sd[base + ".norm_ff_macaron.weight"]),
            "bias": _t(sd[base + ".norm_ff_macaron.bias"]),
        }
    if use_cnn:
        cm = base + ".conv_module"
        cp: dict = {
            "pw1_kernel": _conv_w(sd, cm + ".pointwise_conv1"),
            "pw1_bias": _t(sd[cm + ".pointwise_conv1.bias"]),
            "dw_kernel": _conv_w(sd, cm + ".depthwise_conv"),
            "dw_bias": _t(sd[cm + ".depthwise_conv.bias"]),
            "pw2_kernel": _conv_w(sd, cm + ".pointwise_conv2"),
            "pw2_bias": _t(sd[cm + ".pointwise_conv2.bias"]),
        }
        if cnn_norm == "batch_norm":
            cp["bn_scale"], cp["bn_bias"] = _fold_bn_affine(sd, cm + ".norm")
        else:
            cp["norm"] = {"scale": _t(sd[cm + ".norm.weight"]), "bias": _t(sd[cm + ".norm.bias"])}
        p["conv_module"] = cp
        p["norm_conv"] = {"scale": _t(sd[base + ".norm_conv.weight"]), "bias": _t(sd[base + ".norm_conv.bias"])}
        p["norm_final"] = {"scale": _t(sd[base + ".norm_final.weight"]), "bias": _t(sd[base + ".norm_final.bias"])}
    return p


def _stack_layers(layers: list) -> dict:
    return _stack_trees(layers)


def _linear_embed_params(sd, base) -> dict:
    """LinearNoSubsampling (subsampling.py linear layer: out.0 Linear,
    out.1 LayerNorm)."""
    return {
        "linear": _lin(sd, base + ".out.0"),
        "norm": {"scale": _t(sd[base + ".out.1.weight"]), "bias": _t(sd[base + ".out.1.bias"])},
    }


def upsample_encoder_params_from_reference(
    sd: Mapping[str, Any],
    prefix: str = "",
    num_blocks: int = 6,
    num_up_blocks: int = 4,
    macaron: bool = False,
    use_cnn: bool = False,
) -> dict:
    """UpsampleConformerEncoder (upsample_encoder.py:106-321) -> our
    UpsampleConformerEncoder params. `prefix` is 'encoder.' inside a v2
    flow.pt."""
    p: dict = {
        "embed": _linear_embed_params(sd, prefix + "embed"),
        "pre_lookahead_layer": {
            "conv1_kernel": _conv_w(sd, prefix + "pre_lookahead_layer.conv1"),
            "conv1_bias": _t(sd[prefix + "pre_lookahead_layer.conv1.bias"]),
            "conv2_kernel": _conv_w(sd, prefix + "pre_lookahead_layer.conv2"),
            "conv2_bias": _t(sd[prefix + "pre_lookahead_layer.conv2.bias"]),
        },
        "up_conv_kernel": _conv_w(sd, prefix + "up_layer.conv"),
        "up_conv_bias": _t(sd[prefix + "up_layer.conv.bias"]),
        "up_embed": _linear_embed_params(sd, prefix + "up_embed"),
        "after_norm": {"scale": _t(sd[prefix + "after_norm.weight"]), "bias": _t(sd[prefix + "after_norm.bias"])},
        "encoders": _stack_layers(
            [_conformer_layer_params(sd, f"{prefix}encoders.{i}", macaron, use_cnn) for i in range(num_blocks)]
        ),
        "up_encoders": _stack_layers(
            [_conformer_layer_params(sd, f"{prefix}up_encoders.{i}", macaron, use_cnn) for i in range(num_up_blocks)]
        ),
    }
    return p


def conformer_encoder_params_from_reference(
    sd: Mapping[str, Any],
    prefix: str = "",
    num_blocks: int = 6,
    macaron: bool = True,
    use_cnn: bool = True,
    cnn_norm: str = "batch_norm",
    transformer: bool = False,
) -> dict:
    """(Conformer/Transformer)Encoder (encoder.py:338-474) -> our
    ConformerEncoder params. v1 llm text encoder / v1 flow encoder;
    `transformer=True` for TransformerEncoder stacks (v1 LM: norm1/norm2
    layer norms; the 'linear_legacy' input layer shares the LinearNo-
    Subsampling parameter layout, subsampling.py:352-356)."""
    return {
        "embed": _linear_embed_params(sd, prefix + "embed"),
        "after_norm": {"scale": _t(sd[prefix + "after_norm.weight"]), "bias": _t(sd[prefix + "after_norm.bias"])},
        "encoders": _stack_layers(
            [_conformer_layer_params(sd, f"{prefix}encoders.{i}", macaron, use_cnn, cnn_norm, transformer) for i in range(num_blocks)]
        ),
    }


# --------------------------------------------- U-Net CFM estimator (v1/v2)


def _unet_block1d(sd, base, causal: bool) -> dict:
    """matcha Block1D (conv+GroupNorm) / CausalBlock1D (causal conv+LayerNorm),
    decoder.py:65-78."""
    norm_idx = 2 if causal else 1
    return {
        "kernel": _conv_w(sd, f"{base}.block.0"),
        "bias": _t(sd[f"{base}.block.0.bias"]),
        "norm": {
            "scale": _t(sd[f"{base}.block.{norm_idx}.weight"]),
            "bias": _t(sd[f"{base}.block.{norm_idx}.bias"]),
        },
    }


def _unet_resnet(sd, base, causal: bool) -> dict:
    return {
        "block1": _unet_block1d(sd, f"{base}.block1", causal),
        "block2": _unet_block1d(sd, f"{base}.block2", causal),
        "mlp": _lin(sd, f"{base}.mlp.1"),
        "res_kernel": _conv_w(sd, f"{base}.res_conv"),
        "res_bias": _t(sd[f"{base}.res_conv.bias"]),
    }


def _unet_transformer(sd, base) -> dict:
    """matcha BasicTransformerBlock (transformer.py:138-300, gelu FF)."""
    return {
        "norm1": {"scale": _t(sd[f"{base}.norm1.weight"]), "bias": _t(sd[f"{base}.norm1.bias"])},
        "to_q": {"kernel": _t(sd[f"{base}.attn1.to_q.weight"]).T},
        "to_k": {"kernel": _t(sd[f"{base}.attn1.to_k.weight"]).T},
        "to_v": {"kernel": _t(sd[f"{base}.attn1.to_v.weight"]).T},
        "to_out": _lin(sd, f"{base}.attn1.to_out.0"),
        "norm3": {"scale": _t(sd[f"{base}.norm3.weight"]), "bias": _t(sd[f"{base}.norm3.bias"])},
        "ff_in": _lin(sd, f"{base}.ff.net.0.proj"),
        "ff_out": _lin(sd, f"{base}.ff.net.2"),
    }


def _unet_level(sd, base, n_blocks: int, causal: bool) -> dict:
    p = {"resnet": _unet_resnet(sd, f"{base}.0", causal)}
    for j in range(n_blocks):
        p[f"tb_{j}"] = _unet_transformer(sd, f"{base}.1.{j}")
    return p


def unet_estimator_params(
    sd: Mapping[str, Any],
    prefix: str = "",
    channels: tuple = (256,),
    n_blocks: int = 4,
    num_mid_blocks: int = 12,
    causal: bool = False,
) -> dict:
    """(Causal)ConditionalDecoder (flow/decoder.py:88-494) -> our
    models/unet_decoder.py ConditionalDecoder params. `prefix` is
    'decoder.estimator.' inside a v1/v2 flow.pt."""
    p: dict = {
        "time_mlp_1": _lin(sd, prefix + "time_mlp.linear_1"),
        "time_mlp_2": _lin(sd, prefix + "time_mlp.linear_2"),
        "final_block": _unet_block1d(sd, prefix + "final_block", causal),
        "final_proj_kernel": _conv_w(sd, prefix + "final_proj"),
        "final_proj_bias": _t(sd[prefix + "final_proj.bias"]),
    }
    n_levels = len(channels)
    for i in range(n_levels):
        p[f"down_{i}"] = _unet_level(sd, f"{prefix}down_blocks.{i}", n_blocks, causal)
        ds = f"{prefix}down_blocks.{i}.2"
        # Downsample1D wraps its conv in `.conv`; the is_last plain conv doesn't
        ds_base = ds + ".conv" if ds + ".conv.weight" in sd else ds
        p[f"down_conv_{i}_kernel"] = _conv_w(sd, ds_base)
        p[f"down_conv_{i}_bias"] = _t(sd[ds_base + ".bias"])
    mids = [_unet_level(sd, f"{prefix}mid_blocks.{i}", n_blocks, causal) for i in range(num_mid_blocks)]
    p["mid"] = {"level": _stack_layers(mids)}
    for i in range(n_levels):
        p[f"up_{i}"] = _unet_level(sd, f"{prefix}up_blocks.{i}", n_blocks, causal)
        us = f"{prefix}up_blocks.{i}.2"
        if us + ".conv.weight" in sd:  # Upsample1D conv_transpose
            w = _t(sd[us + ".conv.weight"])  # torch (Cin, Cout, W)
            p[f"up_tconv_{i}_kernel"] = w.transpose(2, 1, 0)
            p[f"up_tconv_{i}_bias"] = _t(sd[us + ".conv.bias"])
        else:
            p[f"up_conv_{i}_kernel"] = _conv_w(sd, us)
            p[f"up_conv_{i}_bias"] = _t(sd[us + ".bias"])
    return p


# --------------------------------------------- CosyVoice1/2 family checkpoints


def llm_v1_params_from_reference(sd: Mapping[str, Any], text_enc_blocks: int = 6, llm_blocks: int = 14) -> dict:
    """CosyVoice1 llm.pt (TransformerLM, llm.py:33-98) -> models/llm_v1.py
    TransformerLM params. text_encoder is a ConformerEncoder (no macaron/cnn,
    conf/cosyvoice.yaml:27-43); llm is a TransformerEncoder (norm1/norm2
    naming + relu ffn + linear_legacy input, yaml:44-56)."""
    return {
        "text_embedding": {"embedding": _t(sd["text_embedding.weight"])},
        "text_encoder": conformer_encoder_params_from_reference(
            sd, "text_encoder.", text_enc_blocks, macaron=False, use_cnn=False
        ),
        "text_encoder_affine_layer": _lin(sd, "text_encoder_affine_layer"),
        "llm_embedding": {"embedding": _t(sd["llm_embedding.weight"])},
        "spk_embed_affine_layer": _lin(sd, "spk_embed_affine_layer"),
        "speech_embedding": {"embedding": _t(sd["speech_embedding.weight"])},
        "llm": conformer_encoder_params_from_reference(
            sd, "llm.", llm_blocks, macaron=False, use_cnn=False, transformer=True
        ),
        "llm_decoder": _lin(sd, "llm_decoder"),
    }


def llm_v2_params_from_reference(sd: Mapping[str, Any], num_layers: int = 24) -> dict:
    """CosyVoice2 llm.pt (Qwen2LM, llm.py:261-353) -> models/llm.py Qwen2LMV2
    params: HF Qwen2 backbone under llm.model.model.*, a 2-row sos/task
    llm_embedding, and a biased speech head (llm.py:271-280)."""
    return {
        "embed_tokens": {"embedding": _t(sd["llm.model.model.embed_tokens.weight"])},
        "llm_embedding": {"embedding": _t(sd["llm_embedding.weight"])},
        "speech_embedding": {"embedding": _t(sd["speech_embedding.weight"])},
        "llm_decoder": _lin(sd, "llm_decoder"),
        "llm": qwen2_params_from_hf(sd, num_layers, prefix="llm.model.model."),
    }


def _regulator_params(sd, prefix: str, num_blocks: int = 4) -> dict:
    """InterpolateRegulator conv stack (length_regulator.py:32-42:
    [Conv1d k3, GroupNorm, Mish] x num_blocks ++ Conv1d k1 at
    model.{3*num_blocks})."""
    p: dict = {}
    for i in range(num_blocks):
        p[f"conv_{i}_kernel"] = _conv_w(sd, f"{prefix}model.{3 * i}")
        p[f"conv_{i}_bias"] = _t(sd[f"{prefix}model.{3 * i}.bias"])
        p[f"norm_{i}_scale"] = _t(sd[f"{prefix}model.{3 * i + 1}.weight"])
        p[f"norm_{i}_bias"] = _t(sd[f"{prefix}model.{3 * i + 1}.bias"])
    p["out_kernel"] = _conv_w(sd, f"{prefix}model.{3 * num_blocks}")
    p["out_bias"] = _t(sd[f"{prefix}model.{3 * num_blocks}.bias"])
    return p


def flow_v1_params_from_reference(
    sd: Mapping[str, Any], num_blocks: int = 6, est_levels: int = 2, est_blocks: int = 4, est_mid: int = 12
) -> dict:
    """CosyVoice1 flow.pt (MaskedDiffWithXvec, flow.py:24-145) ->
    models/flow_xvec.py MaskedDiffWithXvec params. est_* describe the U-Net
    LAYOUT (level/block counts, conf/cosyvoice.yaml:104-113) — dims come from
    the weights themselves."""
    return {
        "input_embedding": {"embedding": _t(sd["input_embedding.weight"])},
        "spk_embed_affine_layer": _lin(sd, "spk_embed_affine_layer"),
        "encoder": conformer_encoder_params_from_reference(
            sd, "encoder.", num_blocks, macaron=False, use_cnn=False
        ),
        "encoder_proj": _lin(sd, "encoder_proj"),
        "length_regulator": _regulator_params(sd, "length_regulator."),
        "estimator": unet_estimator_params(
            sd, "decoder.estimator.", channels=(0,) * est_levels, n_blocks=est_blocks, num_mid_blocks=est_mid, causal=False
        ),
    }


def flow_v2_params_from_reference(
    sd: Mapping[str, Any], num_blocks: int = 6, num_up_blocks: int = 4, est_blocks: int = 4, est_mid: int = 12
) -> dict:
    """CosyVoice2 flow.pt (CausalMaskedDiffWithXvec, flow.py:148-275) ->
    models/flow_xvec.py CausalMaskedDiffWithXvec params."""
    return {
        "input_embedding": {"embedding": _t(sd["input_embedding.weight"])},
        "spk_embed_affine_layer": _lin(sd, "spk_embed_affine_layer"),
        "encoder": upsample_encoder_params_from_reference(sd, "encoder.", num_blocks, num_up_blocks),
        "encoder_proj": _lin(sd, "encoder_proj"),
        "estimator": unet_estimator_params(
            sd, "decoder.estimator.", channels=(0,), n_blocks=est_blocks, num_mid_blocks=est_mid, causal=True
        ),
    }


def hift_nc_params_from_reference(
    sd: Mapping[str, Any],
    upsample_rates: tuple = (8, 5, 3),
    num_resblock_kernels: int = 3,
    resblock_dilations: int = 3,
) -> dict:
    """Non-causal hift.pt (HiFTGenerator, generator.py:378-569) ->
    models/hift.py HiFT params. Unlike the causal stack, ups.{i} are
    weight-normed ConvTranspose1d — torch weight layout (in, out, k) ->
    flax (k, out, in)."""
    p: dict = {
        "conv_pre": _conv(sd, "conv_pre"),
        "conv_post": _conv(sd, "conv_post"),
        "m_source": {"l_linear": _lin(sd, "m_source.l_linear")},
        "f0_predictor": {"classifier": _lin(sd, "f0_predictor.classifier")},
    }
    for i in range(5):
        p["f0_predictor"][f"conv{i}"] = _conv(sd, f"f0_predictor.condnet.{2 * i}")
    for i in range(len(upsample_rates)):
        p[f"ups_{i}_kernel"] = _fold_weight_norm(sd, f"ups.{i}").transpose(2, 1, 0)
        p[f"ups_{i}_bias"] = _t(sd[f"ups.{i}.bias"])
        p[f"source_downs_{i}"] = _conv(sd, f"source_downs.{i}")
        p[f"source_resblocks_{i}"] = _resblock(sd, f"source_resblocks.{i}", resblock_dilations)
        for j in range(num_resblock_kernels):
            p[f"resblocks_{i}_{j}"] = _resblock(sd, f"resblocks.{i * num_resblock_kernels + j}", resblock_dilations)
    return p
