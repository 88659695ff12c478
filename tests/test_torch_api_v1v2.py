"""The CosyVoice2 and CosyVoice (v1) APIs of fangyan_tts_torch against the
JAX package's, each pair on one tiny model directory that both read
(config.json with module-size overrides, msgpack checkpoints, CAM++ and S3,
spk2info.pt, a 24 kHz prompt wav), float32 on the CPU, greedy sampling:
- AutoModel gives the port's CosyVoice2 / CosyVoice by config.json version;
- CosyVoice2 sft (offline and streamed), zero-shot, cross-lingual,
  instruct2 and vc: the same speech tokens, each wav within 1e-3;
- CosyVoice through the whisper-style tokenizer on a `.tiktoken` rank file
  the test writes (token ids equal to the JAX tokenizer's): sft offline
  and streamed, zero-shot, instruct and vc, the same way;
- the v1/v2 converters: the port's copies give the JAX converters' trees
  bit for bit on reference-layout state dicts, and to_jax_tree inverts
  from_jax for every new module.
The v1 flow's CFM noise and the v1 sampler are shared as in
tests/test_torch_v1.py. A greedy step whose top two logits lie within the
bf16-cache rounding may fall either way (tests/test_torch_api.py); the
texts here meet no such near-tie."""

import base64
import json
import warnings
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fangyan_tts_torch.api as tapi
import fangyan_tts_torch.config as tcfg
import fangyan_tts_tpu.api as japi
import fangyan_tts_tpu.config as jcfg
import test_convert as fake
from fangyan_tts_torch.models import convert as tconv
from fangyan_tts_torch.models import from_jax as fj
from fangyan_tts_torch.models import llm_v1 as tv1
from fangyan_tts_torch.models.llm import Qwen2LMV2 as TQwen2LMV2
from fangyan_tts_torch.tokenizer import ByteFallbackTokenizer as TByte
from fangyan_tts_torch.tokenizer import WhisperStyleTokenizer as TWhisper
from fangyan_tts_torch.tokenizer import get_tokenizer as t_get_tokenizer
from fangyan_tts_tpu.data.audio import write_wav
from fangyan_tts_tpu.infer import tts_v12 as jt
from fangyan_tts_tpu.models import convert as jconv
from fangyan_tts_tpu.models import llm_v1_decode as jv1d
from fangyan_tts_tpu.models.flow_xvec import CausalMaskedDiffWithXvec, MaskedDiffWithXvec
from fangyan_tts_tpu.models.hift import HiFT
from fangyan_tts_tpu.models.llm import Qwen2LMV2
from fangyan_tts_tpu.models.llm_v1 import TransformerLM
from fangyan_tts_tpu.ops.sampling import ras_sample
from fangyan_tts_tpu.tokenizer.tokenizer import WhisperStyleTokenizer as JWhisper
from fangyan_tts_tpu.train.checkpoint import save_params
from test_torch_api import CAMP, S3, _jax_makers, _torch_makers
from test_torch_checkpoint import _assert_trees_equal
from test_torch_v1 import _noise
from torch_port_util import GREEDY, QWEN, campplus_oracle, np_params, s3_oracle

WAV_ATOL = 1e-3
V2_FLOW = dict(input_size=32, decoder_channels=[16], num_mid_blocks=1, n_blocks=1, num_heads=2, attention_head_dim=8,
               enc_heads=2, enc_ffn=24, enc_blocks=1, enc_up_blocks=1, n_timesteps=2)
V1_FLOW = dict(V2_FLOW, decoder_channels=[16, 16])
del V1_FLOW["enc_up_blocks"]
V1_LLM = dict(text_token_size=2000, text_encoder_input_size=16, llm_input_size=32, llm_output_size=32,
              text_enc_blocks=1, llm_blocks=2, heads=2, ffn=24)
HIFT_TINY = dict(base_channels=32, f0_cond_channels=16)


def _kw(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _rank_file(path) -> None:
    """A tiny tiktoken rank file: the 256 bytes, then a few merges."""
    merges = [b"th", b"he", b"in", b"the", b"er", b"an", b" t", b"\xe4\xbd", b"\xe5\xa5"]
    toks = [bytes([i]) for i in range(256)] + merges
    path.write_text("".join(f"{base64.b64encode(t).decode()} {r}\n" for r, t in enumerate(toks)))


def _common_files(d, seed: int, sr: int) -> None:
    save_params(d / "campplus.msgpack", jconv.campplus_params_from_torch(campplus_oracle(CAMP, 21).state_dict(),
                                                                         CAMP["block_layers"]))
    save_params(d / "s3tokenizer.msgpack", jconv.s3_params_from_torch(s3_oracle(S3, 22).state_dict())[0])
    rng = np.random.default_rng(seed)
    tt = np.arange(int(2.3 * sr)) / sr
    wav = 0.1 * rng.standard_normal(tt.size) + 0.3 * np.sin(2 * np.pi * 180.0 * tt)
    write_wav(d / "prompt.wav", wav.astype(np.float32), sr)
    torch.save({"spk": {"embedding": torch.from_numpy(rng.standard_normal((1, 192)).astype(np.float32))}},
               d / "spk2info.pt")


def _hift_params(cfg, seed):
    p = np_params(HiFT(cfg), seed, jnp.zeros((1, 16, 80)), gain=0.5)
    p["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)  # voiced
    return p


@pytest.fixture(scope="module")
def v2_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("v2_model")
    base = jcfg.cosyvoice2_config()
    llm = jcfg.LLMConfig(speech_token_size=50, extra_tokens=3, llm_input_size=64, llm_output_size=64,
                         qwen=jcfg.QwenConfig(**QWEN), **GREEDY)
    cfg = jcfg.CosyVoiceConfig(**{**base.__dict__, "llm": llm, "hift": jcfg.HiFTConfig(**HIFT_TINY)})
    (d / "config.json").write_text(json.dumps({**jcfg._to_jsonable(cfg), "xvec_flow": V2_FLOW}))
    t = jnp.zeros((1, 8), jnp.int32)
    save_params(d / "llm.msgpack", np_params(Qwen2LMV2(llm), 3, t, t, jnp.asarray([8]), t, gain=3.0))
    flow = CausalMaskedDiffWithXvec(vocab_size=50, **_kw(V2_FLOW))
    save_params(d / "flow.msgpack", np_params(flow, 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                                              jnp.asarray([16]), jnp.zeros((1, 192)), jnp.zeros((2,), jnp.uint32),
                                              gain=0.7))
    save_params(d / "hift.msgpack", _hift_params(cfg.hift, 2))
    _common_files(d, 7, 24000)
    return d


@pytest.fixture(scope="module")
def v1_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("v1_model")
    base = jcfg.cosyvoice1_config()
    cfg = jcfg.CosyVoiceConfig(**{**base.__dict__, "llm": jcfg.LLMConfig(speech_token_size=50, extra_tokens=1),
                                  "hift": jcfg.HiFTConfig(**{**base.hift.__dict__, **HIFT_TINY})})
    (d / "config.json").write_text(json.dumps({**jcfg._to_jsonable(cfg), "llm_v1": V1_LLM, "xvec_flow": V1_FLOW}))
    t = jnp.zeros((1, 8), jnp.int32)
    save_params(d / "llm.msgpack", np_params(TransformerLM(speech_token_size=50, **V1_LLM), 0, t, jnp.asarray([8]),
                                             t, jnp.asarray([8]), jnp.zeros((1, 192)), gain=1.0))
    flow = MaskedDiffWithXvec(vocab_size=50, **_kw(V1_FLOW))
    save_params(d / "flow.msgpack", np_params(flow, 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                                              jnp.asarray([16]), jnp.zeros((1, 192)), jnp.zeros((2,), jnp.uint32),
                                              gain=0.7))
    save_params(d / "hift.msgpack", _hift_params(cfg.hift, 2))
    _rank_file(d / "multilingual_zh_ja_yue_char_del.tiktoken")
    _common_files(d, 8, 22050)
    return d


def _load_pair(model_dir, mp):
    mp.setattr(japi, "make_campplus_fn", _jax_makers()[0])
    mp.setattr(japi, "make_s3_fn", _jax_makers()[1])
    mp.setattr(tapi, "make_campplus_fn", _torch_makers()[0])
    mp.setattr(tapi, "make_s3_fn", _torch_makers()[1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = japi.AutoModel(str(model_dir), fp16=False)
        tm = tapi.AutoModel(str(model_dir), fp16=False, device="cpu")
    toks = {"jax": [], "port": []}
    for m, rec in ((jm, toks["jax"]), (tm, toks["port"])):
        inner = m.model.token2mel
        m.model.token2mel = lambda tok, *a, _inner=inner, _rec=rec, **k: (_rec.append(np.asarray(tok)),
                                                                         _inner(tok, *a, **k))[1]
    return jm, tm, toks


@pytest.fixture(scope="module")
def v2_models(v2_dir):
    with pytest.MonkeyPatch.context() as mp:
        yield _load_pair(v2_dir, mp)


@pytest.fixture(scope="module")
def v1_models(v1_dir):
    orig_flow = jt.xvec_flow_inference_v1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv1d, "ras_sample", partial(ras_sample, **GREEDY))
        mp.setattr(jt, "xvec_flow_inference_v1",
                   lambda *a, **kw: orig_flow(*a, noise=jnp.asarray(_noise(kw["out_len"])), **kw))
        for k, v in GREEDY.items():
            mp.setitem(tv1.V1_SAMPLING, k, v)
        jm, tm, toks = _load_pair(v1_dir, mp)
        tm.model._flow_noise = lambda out_len: torch.from_numpy(_noise(out_len))
        yield jm, tm, toks


def _compare(models, call, min_chunks: int = 1):
    jm, tm, toks = models
    toks["jax"].clear()
    toks["port"].clear()
    want, got = list(call(jm)), list(call(tm))
    assert len(got) == len(want) >= min_chunks
    assert len(toks["port"]) == len(toks["jax"]) >= 1
    for a, b in zip(toks["port"], toks["jax"]):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got, want):
        g, w = g["tts_speech"], w["tts_speech"]
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=WAV_ATOL)
    assert max(np.abs(w["tts_speech"]).max() for w in want) > 1e-2


def test_automodel_dispatch(v1_models, v2_models):
    assert type(v2_models[1]) is tapi.CosyVoice2 and v2_models[1].sample_rate == 24000
    assert type(v1_models[1]) is tapi.CosyVoice and v1_models[1].sample_rate == 22050
    assert v2_models[1].model.dtype == torch.float32 and v1_models[1].model.dtype == torch.float32
    assert isinstance(v1_models[1].frontend.tokenizer, TWhisper)


V2_CALLS = {
    "sft": lambda m, d: m.inference_sft("你好，世界。", "spk"),
    "zero_shot": lambda m, d: m.inference_zero_shot("今天天气不错。", "提示文本。", str(d / "prompt.wav")),
    "sft_stream": lambda m, d: m.inference_sft("你好，世界。", "spk", stream=True),
    "cross_lingual": lambda m, d: m.inference_cross_lingual("Good.", str(d / "prompt.wav")),
    "instruct2": lambda m, d: m.inference_instruct2("Hello.", "请用湖南话说。<|endofprompt|>",
                                                    str(d / "prompt.wav")),
    "vc": lambda m, d: m.inference_vc(str(d / "prompt.wav"), str(d / "prompt.wav")),
}


@pytest.mark.parametrize("mode", list(V2_CALLS))
def test_cosyvoice2_modes(v2_models, v2_dir, mode):
    _compare(v2_models, lambda m: V2_CALLS[mode](m, v2_dir), min_chunks=2 if "stream" in mode else 1)


V1_CALLS = {
    "sft": lambda m, d: m.inference_sft("你好，世界。", "spk"),
    "sft_stream": lambda m, d: m.inference_sft("你好，世界。", "spk", stream=True),
    "zero_shot": lambda m, d: m.inference_zero_shot("今天天气不错。", "提示文本。", str(d / "prompt.wav")),
    "instruct": lambda m, d: m.inference_instruct("你好。", "spk", "the speaker is happy"),
    "vc": lambda m, d: m.inference_vc(str(d / "prompt.wav"), str(d / "prompt.wav")),
}


@pytest.mark.parametrize("mode", list(V1_CALLS))
def test_cosyvoice_v1_modes(v1_models, v1_dir, mode):
    _compare(v1_models, lambda m: V1_CALLS[mode](m, v1_dir), min_chunks=2 if "stream" in mode else 1)


def test_v1_refuses_instruct2(v1_models):
    with pytest.raises(NotImplementedError, match="CosyVoice2/3"):
        next(v1_models[1].inference_instruct2("你好。", "x<|endofprompt|>", "p.wav"))


@pytest.mark.parametrize("text", ["the theater and <|zh|>你好<|endoftext|>", "<|TTS/SP03|>in her <|0.42|>",
                                  "数字 123 and more"])
def test_whisper_tokenizer_ids(tmp_path, text):
    _rank_file(tmp_path / "r.tiktoken")
    got, want = TWhisper(str(tmp_path / "r.tiktoken")), JWhisper(str(tmp_path / "r.tiktoken"))
    assert got.encode(text) == want.encode(text)
    assert got.vocab_size == want.vocab_size
    assert got.decode(got.encode(text)) == text
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert isinstance(t_get_tokenizer(True, None), TByte)


# ---------------------------------------------------------------- converters


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _w(sd, rng, base, *shape, bias=True):
    sd[base + ".weight"] = _rand(rng, *shape)
    if bias:
        sd[base + ".bias"] = _rand(rng, shape[0])


def _layer_sd(sd, rng, base, transformer=False):
    for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
        _w(sd, rng, f"{base}.self_attn.{n}", 8, 8)
    _w(sd, rng, f"{base}.self_attn.linear_pos", 8, 8, bias=False)
    sd[f"{base}.self_attn.pos_bias_u"] = _rand(rng, 2, 4)
    sd[f"{base}.self_attn.pos_bias_v"] = _rand(rng, 2, 4)
    _w(sd, rng, f"{base}.feed_forward.w_1", 12, 8)
    _w(sd, rng, f"{base}.feed_forward.w_2", 8, 12)
    for n in (("norm1", "norm2") if transformer else ("norm_mha", "norm_ff")):
        _w(sd, rng, f"{base}.{n}", 8)


def _encoder_sd(sd, rng, prefix, n, transformer=False, up=0):
    _w(sd, rng, prefix + "embed.out.0", 8, 8)
    _w(sd, rng, prefix + "embed.out.1", 8)
    _w(sd, rng, prefix + "after_norm", 8)
    for i in range(n):
        _layer_sd(sd, rng, f"{prefix}encoders.{i}", transformer)
    if up:
        _w(sd, rng, prefix + "pre_lookahead_layer.conv1", 8, 8, 4)
        _w(sd, rng, prefix + "pre_lookahead_layer.conv2", 8, 8, 3)
        _w(sd, rng, prefix + "up_layer.conv", 8, 8, 5)
        _w(sd, rng, prefix + "up_embed.out.0", 8, 8)
        _w(sd, rng, prefix + "up_embed.out.1", 8)
        for i in range(up):
            _layer_sd(sd, rng, f"{prefix}up_encoders.{i}")


def _unet_sd(sd, rng, prefix, levels, causal):
    def block(base):
        _w(sd, rng, base + ".block.0", 8, 8, 3)
        _w(sd, rng, f"{base}.block.{2 if causal else 1}", 8)

    def level(base):
        block(base + ".0.block1")
        block(base + ".0.block2")
        _w(sd, rng, base + ".0.mlp.1", 8, 16)
        _w(sd, rng, base + ".0.res_conv", 8, 8, 1)
        tb = base + ".1.0"
        for n in ("norm1", "norm3"):
            _w(sd, rng, f"{tb}.{n}", 8)
        for n in ("to_q", "to_k", "to_v"):
            _w(sd, rng, f"{tb}.attn1.{n}", 8, 8, bias=False)
        _w(sd, rng, tb + ".attn1.to_out.0", 8, 8)
        _w(sd, rng, tb + ".ff.net.0.proj", 32, 8)
        _w(sd, rng, tb + ".ff.net.2", 8, 32)

    _w(sd, rng, prefix + "time_mlp.linear_1", 16, 8)
    _w(sd, rng, prefix + "time_mlp.linear_2", 16, 16)
    block(prefix + "final_block")
    _w(sd, rng, prefix + "final_proj", 80, 8, 1)
    for i in range(levels):
        last = i == levels - 1
        level(f"{prefix}down_blocks.{i}")
        _w(sd, rng, f"{prefix}down_blocks.{i}.2" + ("" if last else ".conv"), 8, 8, 3)
        level(f"{prefix}up_blocks.{i}")
        _w(sd, rng, f"{prefix}up_blocks.{i}.2" + ("" if last else ".conv"), 8, 8, 3 if last else 4)
    level(prefix + "mid_blocks.0")


def _fake_sds(rng) -> dict:
    """Reference-layout state dicts (the keys the converters read; the
    shapes only need the right rank)."""
    v2_llm = tconv.filter_training_meta(fake.fake_llm_sd(rng))
    v2_llm["llm_embedding.weight"] = _rand(rng, 2, 32)
    v2_llm["llm_decoder.bias"] = _rand(rng, 28)
    v1_llm = {}
    for k in ("text_embedding", "llm_embedding", "speech_embedding"):
        v1_llm[k + ".weight"] = _rand(rng, 5, 8)
    for k in ("text_encoder_affine_layer", "spk_embed_affine_layer", "llm_decoder"):
        _w(v1_llm, rng, k, 8, 8)
    _encoder_sd(v1_llm, rng, "text_encoder.", 2)
    _encoder_sd(v1_llm, rng, "llm.", 3, transformer=True)
    flows = {}
    for ver in (1, 2):
        sd = flows[ver] = {"input_embedding.weight": _rand(rng, 5, 8)}
        _w(sd, rng, "spk_embed_affine_layer", 8, 8)
        _w(sd, rng, "encoder_proj", 8, 8)
        _encoder_sd(sd, rng, "encoder.", 2, up=0 if ver == 1 else 1)
        _unet_sd(sd, rng, "decoder.estimator.", 2 if ver == 1 else 1, causal=ver == 2)
    for i in range(4):
        _w(flows[1], rng, f"length_regulator.model.{3 * i}", 8, 8, 3)
        _w(flows[1], rng, f"length_regulator.model.{3 * i + 1}", 8)
    _w(flows[1], rng, "length_regulator.model.12", 8, 8, 1)
    hift = fake.fake_hift_sd(rng)
    w = hift.pop("ups.0.weight")  # one weight-normed transposed conv
    hift["ups.0.weight_g"] = np.sqrt((w * w).sum(axis=(1, 2), keepdims=True))
    hift["ups.0.weight_v"] = w
    return {"v2_llm": v2_llm, "v1_llm": v1_llm, "flow1": flows[1], "flow2": flows[2], "hift": hift}


def test_converters_equal_the_jax_ones():
    sds = _fake_sds(np.random.default_rng(5))
    calls = [
        ("llm_v2_params_from_reference", sds["v2_llm"], dict(num_layers=2)),
        ("llm_v1_params_from_reference", sds["v1_llm"], dict(text_enc_blocks=2, llm_blocks=3)),
        ("flow_v1_params_from_reference", sds["flow1"], dict(num_blocks=2, est_levels=2, est_blocks=1, est_mid=1)),
        ("flow_v2_params_from_reference", sds["flow2"], dict(num_blocks=2, num_up_blocks=1, est_blocks=1,
                                                             est_mid=1)),
        ("hift_nc_params_from_reference", sds["hift"], {}),
        ("hift_nc_params_from_reference", sds["hift"], dict(upsample_rates=(8, 8))),
    ]
    for name, sd, kw in calls:
        want = getattr(jconv, name)(sd, **kw)
        got = getattr(tconv, name)(sd, **kw)
        _assert_trees_equal(got, jax_tree_np(want))


def jax_tree_np(tree):
    return {k: jax_tree_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_to_jax_tree_inverts_from_jax():
    """The port's state_dict of every new module goes back to the JAX tree
    it came from, so the port writes v1/v2 model directories the JAX
    package reads."""
    t = jnp.zeros((1, 8), jnp.int32)
    llm_cfg = (jcfg.LLMConfig(speech_token_size=50, extra_tokens=3, llm_input_size=64, llm_output_size=64,
                              qwen=jcfg.QwenConfig(**QWEN)),
               tcfg.LLMConfig(speech_token_size=50, extra_tokens=3, llm_input_size=64, llm_output_size=64,
                              qwen=tcfg.QwenConfig(**QWEN)))
    hift_cfg = (jcfg.HiFTConfig(**HIFT_TINY), tcfg.HiFTConfig(**HIFT_TINY))
    flow_in = (t, jnp.asarray([8]), jnp.zeros((1, 16, 80)), jnp.asarray([16]), jnp.zeros((1, 192)),
               jnp.zeros((2,), jnp.uint32))
    cases = [
        (np_params(Qwen2LMV2(llm_cfg[0]), 0, t, t, jnp.asarray([8]), t),
         lambda p: fj.llm_v2_from_jax(p, llm_cfg[1]), lambda: TQwen2LMV2(llm_cfg[1])),
        (np_params(TransformerLM(speech_token_size=50, **V1_LLM), 1, t, jnp.asarray([8]), t, jnp.asarray([8]),
                   jnp.zeros((1, 192))),
         lambda p: fj.llm_v1_from_jax(p, speech_token_size=50, **V1_LLM),
         lambda: tv1.TransformerLM(speech_token_size=50, **V1_LLM)),
        (np_params(CausalMaskedDiffWithXvec(vocab_size=50, **_kw(V2_FLOW)), 2, *flow_in),
         lambda p: fj.flow_v2_from_jax(p, vocab_size=50, **_kw(V2_FLOW)),
         lambda: fj.CausalMaskedDiffWithXvec(vocab_size=50, **_kw(V2_FLOW))),
        (np_params(MaskedDiffWithXvec(vocab_size=50, **_kw(V1_FLOW)), 3, *flow_in),
         lambda p: fj.flow_v1_from_jax(p, vocab_size=50, **_kw(V1_FLOW)),
         lambda: fj.MaskedDiffWithXvec(vocab_size=50, **_kw(V1_FLOW))),
        (np_params(HiFT(hift_cfg[0]), 4, jnp.zeros((1, 16, 80))), lambda p: fj.hift_nc_from_jax(p, hift_cfg[1]),
         lambda: fj.HiFT(hift_cfg[1])),
    ]
    for tree, carry, ctor in cases:
        tree = jax_tree_np(tree)
        sd = carry(tree)
        module = ctor()
        module.load_state_dict(sd, strict=True)
        _assert_trees_equal(fj.to_jax_tree(module.state_dict(), module), tree)
