"""The public API, fangyan_tts_torch.api against fangyan_tts_tpu.api, on one
tiny model directory that both read, float32 on the CPU. The directory is
written as tests/test_api.py writes one (config.json, the three msgpack
checkpoints, campplus.msgpack, s3tokenizer.msgpack and a prompt wav, here at
24 kHz so that the prompt is resampled), with the greedy sampling of
tests/torch_port_util.py. Both APIs build their CAM++ / S3 from the
directory through makers replaced for the test (the tiny float32
configurations), as tests/test_api.py replaces the JAX package's.

Held: every inference_* mode gives the same speech tokens and each wav
within 1e-3, offline and streamed (the same chunks); a text generator
(bistream) offline and streamed; AutoModel's dispatch; the .pt -> msgpack
conversion; AutoModel's dispatch of versions 1 and 2 to the port's
CosyVoice and CosyVoice2 (tests/test_torch_api_v1v2.py runs them); and
the port's NotImplementedError of CosyVoice3.inference_instruct.

Both packages decode with a bfloat16 KV cache whatever the model dtype, so
their decode logits agree to about 2e-2 (tests/test_torch_llm.py), and a
greedy step whose top two logits are closer than that may fall either way.
The texts are short ones whose decodes (10-50 tokens) meet no such near-tie
with these weights."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fangyan_tts_torch.api as tapi
import fangyan_tts_tpu.api as japi
import test_convert as fake
from fangyan_tts_torch.infer import frontend as tfe
from fangyan_tts_torch.models.from_jax import llm_from_jax
from fangyan_tts_tpu.infer import frontend as jfe
from fangyan_tts_torch.train.checkpoint import load_params as torch_load_params
from fangyan_tts_tpu.config import _to_jsonable
from fangyan_tts_tpu.data.audio import write_wav
from fangyan_tts_tpu.models.campplus import CAMPPlus
from fangyan_tts_tpu.models.convert import (
    campplus_params_from_torch,
    filter_training_meta,
    llm_params_from_reference,
    s3_params_from_torch,
)
from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT
from fangyan_tts_tpu.models.hift import CausalHiFT
from fangyan_tts_tpu.models.llm import CosyVoice3LM
from fangyan_tts_tpu.models.s3tokenizer import S3TokenizerV3
from fangyan_tts_tpu.train.checkpoint import load_params as jax_load_params
from fangyan_tts_tpu.train.checkpoint import save_params
from torch_port_util import both, campplus_kwargs, campplus_oracle, np_params, s3_kwargs, s3_oracle

WAV_ATOL = 1e-3
# The LLM's kernels have gain 2 (torch_port_util.np_params): at gain 0.5 its
# greedy decode settles into a run of one token, where the logits of two
# tokens cross slowly and a near-tie, which float32 rounding decides either
# way, is certain.
LLM_GAIN = 2.0
JC, TC = both()
CAMP = dict(feat_dim=80, embedding_size=192, growth_rate=4, bn_size=4, init_channels=16, block_layers=(2, 2, 2))
S3 = dict(n_mels=128, n_state=32, n_head=4, n_layer=2, kernel_size=7)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    (d / "config.json").write_text(json.dumps(_to_jsonable(JC)))
    t = jnp.zeros((1, 8), jnp.int32)
    save_params(d / "llm.msgpack", np_params(CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t, gain=LLM_GAIN))
    save_params(d / "flow.msgpack", np_params(CausalMaskedDiffWithDiT(JC.flow), 1, t, jnp.asarray([8]),
                                              jnp.zeros((1, 16, 80)), jnp.asarray([16]), jnp.zeros((1, 192)),
                                              jax.random.PRNGKey(0)))
    hift = np_params(CausalHiFT(JC.hift), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    hift["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)  # voiced frames
    save_params(d / "hift.msgpack", hift)
    save_params(d / "campplus.msgpack", campplus_params_from_torch(campplus_oracle(CAMP, 21).state_dict(),
                                                                   CAMP["block_layers"]))
    save_params(d / "s3tokenizer.msgpack", s3_params_from_torch(s3_oracle(S3, 22).state_dict())[0])
    rng = np.random.default_rng(7)
    tt = np.arange(int(2.3 * 24000)) / 24000.0
    wav = 0.1 * rng.standard_normal(tt.size) + 0.3 * np.sin(2 * np.pi * 180.0 * tt)
    write_wav(d / "prompt.wav", wav.astype(np.float32), 24000)
    return d


def _jax_makers():
    jkw, _ = campplus_kwargs(CAMP)
    cm, sm = CAMPPlus(**jkw), S3TokenizerV3(**s3_kwargs(S3))
    camp = jax.jit(lambda p, f: cm.apply({"params": p}, f))
    s3 = jax.jit(lambda p, m, n: sm.apply({"params": p}, m, n))
    return (lambda params: lambda f: camp(params, f)), (lambda params: lambda m, n: s3(params, m, n))


def _torch_makers():
    _, tkw = campplus_kwargs(CAMP)
    return (lambda params, device=None: tfe.make_campplus_fn(params, device, torch.float32, **tkw),
            lambda params, device=None: tfe.make_s3_fn(params, device, torch.float32, **s3_kwargs(S3)))


def _recorded(model, tokens: list):
    """Record the speech tokens each tts call decodes or is given."""
    inner_gen, inner_mel = model.model.generate_tokens, model.model.token2mel

    def token2mel(tok, *a, **k):
        tokens.append(np.asarray(tok))
        return inner_mel(tok, *a, **k)

    model.model.token2mel = token2mel
    assert inner_gen is not None


@pytest.fixture(scope="module")
def models(model_dir):
    mp = pytest.MonkeyPatch()
    mp.setattr(japi, "make_campplus_fn", _jax_makers()[0])
    mp.setattr(japi, "make_s3_fn", _jax_makers()[1])
    mp.setattr(tapi, "make_campplus_fn", _torch_makers()[0])
    mp.setattr(tapi, "make_s3_fn", _torch_makers()[1])
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jm = japi.CosyVoice3(str(model_dir), fp16=False)
            tm = tapi.AutoModel(str(model_dir), fp16=False, device="cpu")
    finally:
        mp.undo()
    assert isinstance(tm, tapi.CosyVoice3)
    toks = {"jax": [], "port": []}
    _recorded(jm, toks["jax"])
    _recorded(tm, toks["port"])
    return jm, tm, toks


def _compare(models, call):
    jm, tm, toks = models
    toks["jax"].clear()
    toks["port"].clear()
    want, got = list(call(jm)), list(call(tm))
    assert len(got) == len(want) >= 1
    assert len(toks["port"]) == len(toks["jax"]) == len(want)
    for a, b in zip(toks["port"], toks["jax"]):
        np.testing.assert_array_equal(a, b)
        assert len(b) >= 4
    for g, w in zip(got, want):
        g, w = g["tts_speech"], w["tts_speech"]
        assert g.dtype == np.float32 and g.shape == w.shape and len(w) % 480 == 0
        np.testing.assert_allclose(g, w, rtol=0, atol=WAV_ATOL)
        assert np.abs(w).max() > 1e-2


def test_zero_shot(models, model_dir):
    prompt = str(model_dir / "prompt.wav")
    _compare(models, lambda m: m.inference_zero_shot("今天天气不错。", "提示文本。", prompt))


def test_cross_lingual(models, model_dir):
    _compare(models, lambda m: m.inference_cross_lingual("Good.", str(model_dir / "prompt.wav")))


def test_instruct2(models, model_dir):
    _compare(models, lambda m: m.inference_instruct2("Hi there.", "请用湖南话说。<|endofprompt|>",
                                                     str(model_dir / "prompt.wav")))
    for m in models[:2]:
        with pytest.raises(AssertionError, match="endofprompt"):
            next(m.inference_instruct2("你好。", "请用湖南话说。", str(model_dir / "prompt.wav")))


def test_saved_speaker_sft_and_zero_shot(models, model_dir, tmp_path):
    jm, tm, _ = models
    prompt = str(model_dir / "prompt.wav")
    for m in (jm, tm):
        assert m.add_zero_shot_spk("提示文本。", prompt, "spk_a")
        assert "spk_a" in m.list_available_spks()
    _compare(models, lambda m: m.inference_zero_shot("再来一句。", "", "", zero_shot_spk_id="spk_a"))
    # add_zero_shot_spk stores no "embedding", the key of the reference's
    # shipped sft speakers, in either package: sft needs it added
    for m in (jm, tm):
        with pytest.raises(KeyError, match="embedding"):
            next(m.inference_sft("你好。", "spk_a"))
        m.frontend.spk2info["spk_a"]["embedding"] = m.frontend.spk2info["spk_a"]["flow_embedding"]
    _compare(models, lambda m: m.inference_sft("你好，世界。", "spk_a"))
    tm.save_spkinfo()  # <model_dir>/spk2info.pt, which the JAX frontend reads
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        reread = jfe.Frontend(None, JC, spk2info=model_dir / "spk2info.pt")
    assert sorted(reread.spk2info["spk_a"]) == sorted(tm.frontend.spk2info["spk_a"])
    np.testing.assert_array_equal(reread.spk2info["spk_a"]["flow_embedding"],
                                  tm.frontend.spk2info["spk_a"]["flow_embedding"])


def test_vc(models, model_dir):
    _compare(models, lambda m: m.inference_vc(str(model_dir / "prompt.wav"), str(model_dir / "prompt.wav")))


def test_quant_int8(model_dir):
    """quant_int8=True switches the LLM to weight-only int8 on both sides,
    with the same int8 kernels and scales (the quantized decode itself is
    held in tests/test_torch_slice.py)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = japi.CosyVoice3(str(model_dir), fp16=False, load_frontend_models=False, quant_int8=True)
        tm = tapi.CosyVoice3(str(model_dir), fp16=False, load_frontend_models=False, quant_int8=True, device="cpu")
    assert tm.model.cfg.llm.qwen.quant_int8 and tm.model.llm.llm.layers[0].mlp.gate_up_proj.bits == 8
    assert tm.frontend.campplus_fn is None and tm.frontend.s3_fn is None
    want = llm_from_jax(jax.tree.map(np.asarray, jm.model.llm_params), tm.model.cfg.llm)
    got = tm.model.llm.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_unported_modes_raise(models, model_dir):
    """inference_instruct is v1-only in both packages. A text generator and
    stream=True, which raised here before the streaming slice was ported,
    now run (test_stream_modes, test_text_generator)."""
    _, tm, _ = models
    with pytest.raises(NotImplementedError, match="v1"):
        next(tm.inference_instruct("你好。", "spk_a", "开心地说"))
    chunks = list(tm.inference_cross_lingual("你好。", str(model_dir / "prompt.wav"), stream=True))
    assert len(chunks) >= 1 and all(c["tts_speech"].dtype == np.float32 for c in chunks)


def _compare_stream(models, call):
    """Streamed chunks: the same count and lengths as the JAX package's,
    each within WAV_ATOL, and as many samples as the offline call gives."""
    jm, tm, _ = models
    want, got = list(call(jm, True)), list(call(tm, True))
    assert [len(g["tts_speech"]) for g in got] == [len(w["tts_speech"]) for w in want]
    for g, w in zip(got, want):
        assert g["tts_speech"].dtype == np.float32
        np.testing.assert_allclose(g["tts_speech"], w["tts_speech"], rtol=0, atol=WAV_ATOL)
    offline = list(call(tm, False))
    assert sum(len(g["tts_speech"]) for g in got) == sum(len(o["tts_speech"]) for o in offline)
    assert max(np.abs(w["tts_speech"]).max() for w in want) > 1e-2


@pytest.mark.parametrize("mode", ["zero_shot", "cross_lingual", "instruct2", "vc"])
def test_stream_modes(models, model_dir, mode):
    prompt = str(model_dir / "prompt.wav")
    calls = {
        "zero_shot": lambda m, s: m.inference_zero_shot("今天天气不错。", "提示文本。", prompt, stream=s),
        "cross_lingual": lambda m, s: m.inference_cross_lingual("Good.", prompt, stream=s),
        "instruct2": lambda m, s: m.inference_instruct2("Hi there.", "请用湖南话说。<|endofprompt|>", prompt, stream=s),
        "vc": lambda m, s: m.inference_vc(prompt, prompt, stream=s),
    }
    _compare_stream(models, calls[mode])


@pytest.mark.parametrize("stream", [False, True])
def test_text_generator(models, model_dir, stream):
    """inference_zero_shot with a generator of text pieces (bistream)."""
    def gen():
        yield "今天"
        yield "天气不错。"

    jm, tm, _ = models
    prompt = str(model_dir / "prompt.wav")
    want = list(jm.inference_zero_shot(gen(), "提示文本。", prompt, stream=stream))
    got = list(tm.inference_zero_shot(gen(), "提示文本。", prompt, stream=stream))
    assert [len(g["tts_speech"]) for g in got] == [len(w["tts_speech"]) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["tts_speech"], w["tts_speech"], rtol=0, atol=WAV_ATOL)
    assert sum(len(w["tts_speech"]) for w in want) >= 4 * 960


@pytest.mark.parametrize("files, version", [
    ({"config.json": json.dumps({"version": 1})}, 1), ({"config.json": json.dumps({"version": 2})}, 2),
    ({"cosyvoice2.yaml": ""}, 2), ({"cosyvoice.yaml": ""}, 1),
])
def test_automodel_refuses_v1_v2(tmp_path, files, version, monkeypatch):
    """Versions 1 and 2 are no longer refused: they go to CosyVoice and
    CosyVoice2, which then look for their checkpoints."""
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    cls = {1: tapi.CosyVoice, 2: tapi.CosyVoice2}[version]
    with pytest.raises(FileNotFoundError, match="llm"):
        tapi.AutoModel(str(tmp_path), device="cpu", fp16=False)
    seen = []
    monkeypatch.setattr(tapi, cls.__name__, lambda d, **kw: seen.append((d, kw)))
    tapi.AutoModel(str(tmp_path), device="cpu")
    assert seen == [(str(tmp_path), {"device": "cpu"})]


@pytest.mark.parametrize("files", [{"cosyvoice3.yaml": ""}, {"config.json": "{}"}, {}])
def test_automodel_takes_v3(tmp_path, files):
    """Version 3 goes to CosyVoice3, which then looks for its checkpoints."""
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    with pytest.raises(FileNotFoundError, match="llm"):
        tapi.AutoModel(str(tmp_path), device="cpu", fp16=False)


def test_pt_checkpoints_convert_to_msgpack(tmp_path):
    """<name>.pt (a training checkpoint with epoch/step) becomes <name>.msgpack
    on first load: the port writes the file the JAX package writes."""
    sd = dict(campplus_oracle(CAMP, 5).state_dict(), epoch=3, step=100)
    llm_sd = {k: v if isinstance(v, int) else torch.from_numpy(v) for k, v in fake.fake_llm_sd(
        np.random.default_rng(3)).items()}
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        torch.save(sd, tmp_path / side / "campplus.pt")
        torch.save(llm_sd, tmp_path / side / "llm.pt")
    convs = {"campplus": lambda s: campplus_params_from_torch(s, CAMP["block_layers"]),
             "llm": lambda s: llm_params_from_reference(s, num_layers=2)}
    for name, conv in convs.items():
        got = tapi._maybe_convert(tmp_path / "port", name, conv)
        want = japi._maybe_convert(tmp_path / "jax", name, conv)
        assert got.name == want.name == f"{name}.msgpack"
        assert got.read_bytes() == want.read_bytes()
        assert tapi._maybe_convert(tmp_path / "port", name, None) == got  # the msgpack is used from now on
    tree = torch_load_params(tmp_path / "port" / "campplus.msgpack")
    ref = jax_load_params(tmp_path / "jax" / "campplus.msgpack")
    np.testing.assert_array_equal(tree["emb_bn"]["var"], ref["emb_bn"]["var"])
    assert filter_training_meta(sd).keys() == sd.keys() - {"epoch", "step"}
    assert tapi._maybe_convert(tmp_path / "port", "flow", None) is None


def test_deep_merge_equal():
    base = {"llm": {"a": 1, "b": {"c": 2, "d": 3}}, "x": 1}
    extra = {"llm": {"b": {"c": 5}}, "y": 2, "x": {"z": 1}}
    assert tapi._deep_merge(base, extra) == japi._deep_merge(base, extra) == {
        "llm": {"a": 1, "b": {"c": 5, "d": 3}}, "x": {"z": 1}, "y": 2}
