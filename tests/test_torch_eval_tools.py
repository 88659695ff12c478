"""The evaluation and model-dir tools of fangyan_tts_torch against the JAX
package's, on the CPU:

- every case of tests/test_evaluate.py (eval lists, CER units, CER): equal
  results; CAM++ speaker similarity within 1e-4 of the JAX package's, and a
  wav scored against itself at 1 within 1e-4;
- `run_eval` end to end on the tiny model directory of
  tests/test_torch_api.py (float32 on both sides) with a stub ASR: the same
  rows, CER equal, wavs within 1e-3, per-utterance SS within 1e-4 on the
  same wavs, and score_only synthesizing nothing;
- tests/test_prepare_model_dir.py's cases, and a directory prepared from a
  reference-layout llm.pt loading in the port's AutoModel with the weights
  the JAX package's conversion gives;
- the tokenizer self-check (tokenizer/parity.py) on a tiny HF tokenizer
  with no reference tree: the JAX package's result;
- `make_asr_fn` raising as the JAX package's does without funasr /
  transformers;
- `trace` and `span` (the tracer).

Both packages decode with a bf16 KV cache (tests/test_torch_api.py's
docstring), so run_eval's texts are ones whose greedy decodes meet no
near-tie with this model and prompt: the two sentences of
tests/test_torch_api.py's zero-shot and saved-speaker requests.
"""

import json
import sys
import warnings

import numpy as np
import pytest
import torch

import fangyan_tts_torch.api as tapi
import fangyan_tts_tpu.api as japi
from fangyan_tts_torch.cli import evaluate as tev
from fangyan_tts_torch.cli import prepare_model_dir as tpm
from fangyan_tts_tpu.cli import evaluate as jev
from fangyan_tts_tpu.cli import prepare_model_dir as jpm
from test_torch_api import _jax_makers, _torch_makers, model_dir  # noqa: F401 (a fixture)

SS_ATOL = 1e-4
WAV_ATOL = 1e-3


# ---------------------------------------------------------------- text layer

@pytest.mark.parametrize("lines", [
    "utt1|提示文本|/x/p1.wav|目标文本。\nutt2|hello there|/x/p2.wav|say this\n",
    json.dumps({"utt": "a", "prompt_wav": "w.wav", "target_text": "你好"}, ensure_ascii=False) + "\n\n",
])
def test_load_eval_list(tmp_path, lines):
    p = tmp_path / "meta.lst"
    p.write_text(lines, encoding="utf-8")
    assert tev.load_eval_list(p) == jev.load_eval_list(p) and len(tev.load_eval_list(p)) >= 1
    p.write_text("a|b|c\n", encoding="utf-8")
    for mod in (tev, jev):
        with pytest.raises(ValueError, match="meta.lst"):
            mod.load_eval_list(p)


@pytest.mark.parametrize("text, lang", [("你好，世界！", "zh"), ("Hello, World!", "en"), ("混合 text，数字 123。", "zh")])
def test_normalize_units(text, lang):
    assert tev.normalize_for_cer(text, lang) == jev.normalize_for_cer(text, lang)


@pytest.mark.parametrize("ref, hyp, lang, want", [
    ("你好世界", "你好世界", "auto", 0.0), ("你好，世界。", "你好地界", "auto", 0.25),
    ("今天天气", "今天气好", "auto", 0.5), ("say this now", "say that now", "en", 1 / 3),
    ("Say this now.", "say this now", "auto", 0.0), ("你好", "", "auto", 1.0),
])
def test_score_cer(ref, hyp, lang, want):
    got = tev.score_cer(ref, hyp, lang=lang)
    assert got == jev.score_cer(ref, hyp, lang=lang) == pytest.approx(want)


# ------------------------------------------------------- SS and run_eval

@pytest.fixture(scope="module")
def models(model_dir):  # noqa: F811
    mp = pytest.MonkeyPatch()
    mp.setattr(japi, "make_campplus_fn", _jax_makers()[0])
    mp.setattr(japi, "make_s3_fn", _jax_makers()[1])
    mp.setattr(tapi, "make_campplus_fn", _torch_makers()[0])
    mp.setattr(tapi, "make_s3_fn", _torch_makers()[1])
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jm = japi.CosyVoice3(str(model_dir), fp16=False)
            tm = tapi.CosyVoice3(str(model_dir), fp16=False, device="cpu")
    finally:
        mp.undo()
    return jm, tm


def _tone(f0: float, seconds: float = 2.0, sr: int = 16000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def test_speaker_similarity(models):
    jm, tm = models
    a, a2, b = _tone(120.0, seed=1), _tone(120.0, seed=2), _tone(310.0, seed=3)
    for x, y in ((a, a), (a, a2), (a, b)):
        got = tev.speaker_similarity(tm.frontend, x, y)
        assert abs(got - jev.speaker_similarity(jm.frontend, x, y)) <= SS_ATOL and -1.0 <= got <= 1.0
    assert tev.speaker_similarity(tm.frontend, a, a) == pytest.approx(1.0, abs=SS_ATOL)


def test_run_eval_end_to_end(models, model_dir, tmp_path):  # noqa: F811
    """Both packages synthesize and score the same pairs: equal hyps and
    CERs, wavs within 1e-3. SS is held on the same wavs: the port scores the
    JAX package's wavs (score_only, which synthesizes nothing) within 1e-4
    of the JAX package's SS. The tiny random CAM++ is so sensitive (x-vector
    entries in the hundreds) that the two packages' wavs, 3e-5 apart, move
    SS by about 2e-3, so SS is not compared across the two syntheses."""
    jm, tm = models
    prompt = str(model_dir / "prompt.wav")
    pairs = [{"utt": "u1", "prompt_text": "提示文本。", "prompt_wav": prompt, "target_text": "今天天气不错。"},
             {"utt": "u2", "prompt_text": "提示文本。", "prompt_wav": prompt, "target_text": "今天天气不错。"}]
    asr = lambda wav, sr: "今天天汽不错。"  # noqa: E731 - one substitution in six units
    out = {}
    for name, mod, m in (("jax", jev, jm), ("port", tev, tm)):
        out[name] = mod.run_eval(str(model_dir), pairs, tmp_path / name, asr_fn=asr, model=m)
    want, got = out["jax"], out["port"]
    assert got["n"] == want["n"] == 2 and got["cer"] == want["cer"] == pytest.approx(1 / 6)
    for g, w in zip(got["per_utt"], want["per_utt"]):
        assert g["utt"] == w["utt"] and g["hyp"] == w["hyp"] and g["cer"] == w["cer"]
        assert -1.0 <= g["ss"] <= 1.0
    from fangyan_tts_torch.data.audio import read_wav

    for utt in ("u1", "u2"):
        g, _ = read_wav(tmp_path / "port" / f"{utt}.wav")
        w, _ = read_wav(tmp_path / "jax" / f"{utt}.wav")
        assert g.shape == w.shape and len(w) >= 4 * 480
        np.testing.assert_allclose(g, w, rtol=0, atol=WAV_ATOL)
        (tmp_path / "on_jax").mkdir(exist_ok=True)
        (tmp_path / "on_jax" / f"{utt}.wav").write_bytes((tmp_path / "jax" / f"{utt}.wav").read_bytes())
    summary = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert summary == {"n": 2, "ss": got["ss"], "cer": got["cer"]}
    rows = [json.loads(line) for line in (tmp_path / "port" / "results.jsonl").read_text().splitlines()]
    assert [r["utt"] for r in rows] == ["u1", "u2"]
    # score_only on the JAX package's wavs: no synthesis, CER skipped without an ASR, SS as the JAX package's
    m1 = (tmp_path / "on_jax" / "u1.wav").stat().st_mtime_ns
    again = tev.run_eval(str(model_dir), pairs, tmp_path / "on_jax", asr_fn=None, score_only=True, model=tm)
    assert (tmp_path / "on_jax" / "u1.wav").stat().st_mtime_ns == m1 and again["cer"] is None
    for g, w in zip(again["per_utt"], want["per_utt"]):
        assert abs(g["ss"] - w["ss"]) <= SS_ATOL


def test_make_asr_routes(monkeypatch):
    """funasr / whisper are gated with the JAX package's RuntimeError, echo
    transcribes nothing, 'none' skips CER, 'http' is a stdlib client."""
    from fangyan_tts_torch.runtime import token2wav_asr_server as tsrv
    from fangyan_tts_tpu.runtime import token2wav_asr_server as jsrv

    monkeypatch.setitem(sys.modules, "funasr", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    for backend, match in (("funasr", "funasr is not installed"), ("whisper", "Whisper unavailable")):
        for mod in (tsrv, jsrv):
            with pytest.raises(RuntimeError, match=match):
                mod.make_asr_fn(backend)
        with pytest.raises(RuntimeError, match=match):
            tev.make_asr(backend, None)
    for mod in (tsrv, jsrv):
        assert mod.make_asr_fn("echo")(np.zeros(16), 16000) == ""
        with pytest.raises(ValueError, match="unknown ASR backend"):
            mod.make_asr_fn("nope")
    assert tev.make_asr("none", None) is None and callable(tev.make_asr("http", "http://127.0.0.1:1/asr"))


# -------------------------------------------------------- prepare_model_dir

def test_detect_version(tmp_path):
    assert tpm.detect_version(tmp_path) == jpm.detect_version(tmp_path) == 3
    (tmp_path / "cosyvoice2.yaml").write_text("llm: {}\n")
    assert tpm.detect_version(tmp_path) == jpm.detect_version(tmp_path) == 2
    (tmp_path / "config.json").write_text(json.dumps({"version": 1}))
    assert tpm.detect_version(tmp_path) == jpm.detect_version(tmp_path) == 1


def test_prepare_skips_existing_and_writes_config(tmp_path):
    from fangyan_tts_torch.train.checkpoint import save_params

    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        save_params(d / "llm.msgpack", {"w": np.zeros(2, np.float32)})
        (d / "llm.pt").write_bytes(b"not-read-because-msgpack-exists")
        (d / "cosyvoice3.yaml").write_text("sample_rate: 24000\n")
    got, want = tpm.prepare_model_dir(str(tmp_path / "port")), jpm.prepare_model_dir(str(tmp_path / "jax"))
    assert got == want and got["version"] == 3
    assert "llm.msgpack (exists)" in got["skipped"] and "config.json" in got["converted"]
    cfg = json.loads((tmp_path / "port" / "config.json").read_text())
    assert cfg == json.loads((tmp_path / "jax" / "config.json").read_text())
    assert cfg["version"] == 3 and cfg["sample_rate"] == 24000


def reference_llm_sd(tree: dict, cfg) -> dict:
    """The JAX package's CosyVoice3LM parameter tree in the reference llm.pt
    layout (models/convert.llm_params_from_reference inverted), with the
    epoch / step entries of a training checkpoint."""
    q = cfg.qwen
    nq, nkv = q.num_attention_heads * q.head_dim, q.num_key_value_heads * q.head_dim
    t = lambda x: torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))  # noqa: E731
    lay = tree["llm"]["layers"]
    sd = {"llm.model.model.embed_tokens.weight": t(tree["embed_tokens"]["embedding"]),
          "speech_embedding.weight": t(tree["speech_embedding"]["embedding"]),
          "llm_decoder.weight": t(np.asarray(tree["llm_decoder"]["kernel"]).T),
          "llm.model.model.norm.weight": t(tree["llm"]["norm"]["weight"]), "epoch": 3, "step": 100}
    for i in range(q.num_hidden_layers):
        p = f"llm.model.model.layers.{i}."
        qkv, b = np.asarray(lay["self_attn"]["qkv_proj"]["kernel"][i]), np.asarray(lay["self_attn"]["qkv_proj"]["bias"][i])
        for name, sl in (("q_proj", slice(0, nq)), ("k_proj", slice(nq, nq + nkv)), ("v_proj", slice(nq + nkv, None))):
            sd[p + f"self_attn.{name}.weight"], sd[p + f"self_attn.{name}.bias"] = t(qkv[:, sl].T), t(b[sl])
        sd[p + "self_attn.o_proj.weight"] = t(np.asarray(lay["self_attn"]["o_proj"]["kernel"][i]).T)
        gu = np.asarray(lay["mlp"]["gate_up_proj"]["kernel"][i])
        sd[p + "mlp.gate_proj.weight"], sd[p + "mlp.up_proj.weight"] = t(gu[:, : q.intermediate_size].T), t(
            gu[:, q.intermediate_size :].T)
        sd[p + "mlp.down_proj.weight"] = t(np.asarray(lay["mlp"]["down_proj"]["kernel"][i]).T)
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[p + f"{n}.weight"] = t(lay[n]["weight"][i])
    return sd


def test_prepared_dir_loads_in_automodel(tmp_path, model_dir):  # noqa: F811
    """A reference llm.pt beside the other msgpacks: prepare_model_dir writes
    the msgpack the JAX package's writes, and the port's AutoModel loads the
    directory with the LLM the JAX package's conversion gives. Both
    packages' prepare_model_dir convert an llm.pt of 24 layers (the
    converters' default), so the tiny LLM's two layers are repeated to 24."""
    from fangyan_tts_torch.models.from_jax import llm_from_jax
    from fangyan_tts_torch.train.checkpoint import load_params

    cfg = json.loads((model_dir / "config.json").read_text())
    cfg["llm"]["qwen"]["num_hidden_layers"] = 24
    tree = load_params(model_dir / "llm.msgpack")
    tree["llm"]["layers"] = _repeat(tree["llm"]["layers"], 12)
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        (d / "config.json").write_text(json.dumps(cfg))
        for f in ("flow.msgpack", "hift.msgpack"):
            (d / f).write_bytes((model_dir / f).read_bytes())
        torch.save(reference_llm_sd(tree, tapi.config_from_dict(cfg).llm), d / "llm.pt")
    got = tpm.prepare_model_dir(str(tmp_path / "port"))
    want = jpm.prepare_model_dir(str(tmp_path / "jax"))
    assert got == want and got["converted"] == ["llm.msgpack"]
    assert (tmp_path / "port" / "llm.msgpack").read_bytes() == (tmp_path / "jax" / "llm.msgpack").read_bytes()
    m = tapi.AutoModel(str(tmp_path / "port"), fp16=False, load_frontend_models=False, device="cpu")
    assert isinstance(m, tapi.CosyVoice3) and len(m.model.llm.llm.layers) == 24
    ref = llm_from_jax(load_params(tmp_path / "jax" / "llm.msgpack"), m.cfg.llm)
    got_sd = m.model.llm.state_dict()
    assert sorted(got_sd) == sorted(ref)
    for k, v in ref.items():
        torch.testing.assert_close(got_sd[k], v.float(), rtol=0, atol=0)


def _repeat(tree, n: int):
    """Every leaf of a stacked-layers tree repeated n times along the layer axis."""
    if isinstance(tree, dict):
        return {k: _repeat(v, n) for k, v in tree.items()}
    return np.concatenate([np.asarray(tree)] * n)


# ------------------------------------------------------- tokenizer self-check

@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A tiny offline HF fast tokenizer (tests/test_tokenizer_v23_parity.py's)."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    d = tmp_path_factory.mktemp("qwen_fixture")
    words = ["<unk>", "<|endoftext|>", "hello", "world", "你", "好", "请", "说", "。", ",", "a", "b"]
    t = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    t.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    t.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        '{"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|endoftext|>", "unk_token": "<unk>"}')
    return str(d)


@pytest.mark.parametrize("version", ["cosyvoice2", "cosyvoice3"])
def test_tokenizer_self_check(tok_dir, version, monkeypatch):
    from fangyan_tts_torch.tokenizer import parity as tpar
    from fangyan_tts_tpu.tokenizer import parity as jpar

    monkeypatch.delenv("COSYVOICE_REF", raising=False)
    monkeypatch.setattr(jpar, "default_reference_root", lambda: None)
    got = tpar.check_tokenizer_parity(tok_dir, version=version)
    assert got == jpar.check_tokenizer_parity(tok_dir, version=version)
    assert got["self_check"] == "ok" and got["reference"] == "unavailable"
    assert tpar.default_reference_root() is None


# ---------------------------------------------------------------- profiling

def test_stage_timer_and_trace(tmp_path):
    """`trace()` profiles a block and the tracer afresh: a span opened
    inside it is in the Chrome trace (its record_function range) and in
    `spans()`, and the block's spans and counters are written beside it."""
    from fangyan_tts_torch.utils import profiling as tprof

    with tprof.span("before"):  # no profiler, no recording
        pass
    with tprof.trace(str(tmp_path / "trace")):
        with tprof.span("span", rows=4):
            torch.ones(4).sum()
        tprof.count("things", 3)
    assert "span" in (tmp_path / "trace" / "trace.json").read_text()
    got = tprof.spans()
    assert [s["name"] for s in got] == ["span"] and got[0]["attrs"] == {"rows": 4}
    assert got[0]["t1_ns"] >= got[0]["t0_ns"] and tprof.counters() == {"things": 3}
    program = json.loads((tmp_path / "trace" / "program.json").read_text())
    assert [s["name"] for s in program["spans"]] == ["span"]
    assert program["counters"] == {"things": 3} and program["dropped"] == 0
    tprof.reset()


def test_set_all_random_seed():
    import random

    from fangyan_tts_torch.utils.common import INSTRUCT_LIST, set_all_random_seed
    from fangyan_tts_tpu.utils.common import INSTRUCT_LIST as JLIST

    assert INSTRUCT_LIST == JLIST and len(INSTRUCT_LIST) == 26
    draws = []
    for _ in range(2):
        set_all_random_seed(5)
        draws.append((random.random(), np.random.rand(), torch.rand(1).item()))
    assert draws[0] == draws[1]
