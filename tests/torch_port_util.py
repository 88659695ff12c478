"""Shared pieces of the tests that hold fangyan_tts_torch against the JAX
package: tiny configurations built on both sides from the same numbers,
and numpy-initialised JAX parameter trees (weights scaled by 1/sqrt(fan_in),
so activations stay of order one and every path is exercised)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import torch

import fangyan_tts_torch.config as tcfg
import fangyan_tts_tpu.config as jcfg

# The suite runs in several worker processes at once; torch's default of one
# CPU thread per core in each of them starves the other workers' tests, some
# of which depend on timing.
torch.set_num_threads(1)

QWEN = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, vocab_size=300)
LLM = dict(llm_input_size=64, llm_output_size=64, speech_token_size=50, extra_tokens=8)
GREEDY = dict(top_k=1, tau_r=1.1)  # neither side draws: the nucleus is the argmax, RAS never falls back
DIT = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, static_chunk_size=10)
FLOW = dict(input_size=80, vocab_size=50, n_timesteps=4, pre_lookahead_channels=64)
HIFT = dict(base_channels=64, f0_cond_channels=32)


def configs(mod, greedy: bool = True):
    """The tiny CosyVoiceConfig of `mod` (either package's config module)."""
    llm = mod.LLMConfig(**LLM, **(GREEDY if greedy else {}), qwen=mod.QwenConfig(**QWEN))
    flow = mod.FlowConfig(**FLOW, dit=mod.DiTConfig(**DIT))
    return mod.CosyVoiceConfig(llm=llm, flow=flow, hift=mod.HiFTConfig(**HIFT))


def both(greedy: bool = True):
    return configs(jcfg, greedy), configs(tcfg, greedy)


def np_params(model, seed: int, *init_args, gain: float = 1.0, **init_kwargs) -> dict:
    """Parameters for a flax module from numpy: N(0, gain^2/fan_in) kernels,
    N(0, 1/dim) embeddings, 1 + N(0, 0.01) norm weights and snake alphas,
    N(0, 0.01) biases. Stacked ('layers'/'blocks') leaves count fan-in
    without the layer axis."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *init_args, **init_kwargs))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(k, "key", k)) for k in path]
        shape = leaf.shape
        core = shape[1:] if any(n in ("layers", "blocks") for n in names) else shape
        name = names[-1]
        if len(core) >= 2:
            fan_in = shape[-1] if name == "embedding" else int(np.prod(core[:-1]))
            return (gain * rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "weight" or "alpha" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def capture_grads():
    """An optax transformation that passes the gradients on unchanged and
    keeps them in its state: chained before a JAX optimizer, a JAX train
    step reports its own gradients and steps as that optimizer alone."""
    import optax

    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))



def campplus_oracle(tiny: dict, seed: int):
    """A tests/oracles CAM++ in eval mode with N(0, 0.04) weights and
    non-trivial BatchNorm statistics (as tests/test_campplus_parity.py
    makes it)."""
    from oracles.campplus_torch import CAMPPlus

    gen = torch.Generator().manual_seed(seed)
    m = CAMPPlus(**tiny).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        for mod in m.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=gen) * 0.5 + 0.75)
                if mod.affine:
                    mod.weight.data.copy_(torch.randn(mod.weight.shape, generator=gen) * 0.2 + 1.0)
                    mod.bias.data.copy_(torch.randn(mod.bias.shape, generator=gen) * 0.1)
    return m


def s3_oracle(tiny: dict, seed: int):
    """A tests/oracles S3 tokenizer in eval mode with N(0, 0.04) weights."""
    from oracles.s3tokenizer_torch import S3TokenizerV2

    gen = torch.Generator().manual_seed(seed)
    m = S3TokenizerV2(**tiny).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return m


def campplus_kwargs(tiny: dict) -> tuple[dict, dict]:
    """(the JAX CAMPPlus's kwargs, the port's) for an oracle configuration."""
    j = dict(embedding_size=tiny["embedding_size"], init_channels=tiny["init_channels"], growth=tiny["growth_rate"],
             bn_size=tiny["bn_size"], block_layers=tiny["block_layers"])
    return j, dict(j, feat_dim=tiny["feat_dim"])


def s3_kwargs(tiny: dict) -> dict:
    """The kwargs of either package's S3TokenizerV3 for an oracle configuration."""
    return dict(dim=tiny["n_state"], heads=tiny["n_head"], layers=tiny["n_layer"], n_mels=tiny["n_mels"],
                fsmn_kernel=tiny["kernel_size"])


# CAM++ and S3 at sizes whose features are the real ones (80 fbank bins, 128
# whisper mels, 192-d x-vectors, as the training pipeline's collates need)
# and whose depth and width are tiny
FE_CAMP = dict(feat_dim=80, embedding_size=192, growth_rate=4, bn_size=4, init_channels=16, block_layers=(2, 2, 2))
FE_S3 = dict(n_mels=128, n_state=32, n_head=4, n_layer=2, kernel_size=7)


def speech_like(n: int, sr: int, rng) -> np.ndarray:
    """float32 audio of n samples: a voiced harmonic series on a gliding f0,
    a syllable-rate envelope and a little noise, so S3 codes vary."""
    t = np.arange(n) / sr
    f0 = rng.uniform(100.0, 220.0) + 30.0 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(h * phase + h) / h for h in range(1, 9))
    env = 0.3 + np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t) ** 2
    x = env * voiced + 0.05 * rng.standard_normal(n)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def write_corpus(root, lengths, seed: int, spk_size: int = 4, sr: int = 16000) -> dict:
    """A Kaldi directory under `root`: one 16-bit wav per entry of `lengths`
    (samples) in root/wavs, wav.scp / text / utt2spk / spk2utt / instruct,
    speaker-major (spk_size utterances a speaker). Returns wav.scp as a dict."""
    from pathlib import Path

    from fangyan_tts_tpu.data import kaldi_io
    from fangyan_tts_tpu.data.audio import write_wav

    root = Path(root)
    (root / "wavs").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    wav_scp, text, utt2spk, instruct = {}, {}, {}, {}
    for i, n in enumerate(lengths):
        u = f"utt{i:03d}"
        write_wav(root / "wavs" / f"{u}.wav", speech_like(int(n), sr, rng), sr)
        wav_scp[u] = str(root / "wavs" / f"{u}.wav")
        text[u] = f"这是第{i}句测试文本。"
        utt2spk[u] = f"spk{i // spk_size}"
        instruct[u] = "请用四川话说。<|endofprompt|>"
    kaldi_io.write_kaldi_dir(root, wav_scp, text, utt2spk, instruct)
    return wav_scp
