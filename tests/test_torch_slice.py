"""The whole offline slice, `CosyVoice3TTS.tts(stream=False)`, and the
batched `batch_synthesize`, unquantized and in the weight-only int8 +
int4-MLP LLM / int8 flow mode, on both sides with the same weights
(models/from_jax.py) and a greedy sampling config, float32: equal speech
tokens and each wav within 1e-3. Plus the port's guards: it imports no JAX,
its entry points refuse to fall back to the CPU, its models refuse the JAX
package's decode-path options, quantize_llm keeps the JAX package's
idempotence, its kernel wrappers count no launch for CPU tensors, and
from_jax rejects a parameter tree that does not fit."""

import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.infer.tts import CosyVoice3TTS as TorchTTS
from fangyan_tts_torch.models.from_jax import flow_from_jax, hift_from_jax, llm_from_jax
from fangyan_tts_torch.ops import decode_attention as tda
from fangyan_tts_torch.ops import device as tdevice
from fangyan_tts_torch.ops import flash_attention as tfa
from fangyan_tts_torch.ops import int4_matmul as ti4
from fangyan_tts_tpu.infer.tts import CosyVoice3TTS as JaxTTS
from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT
from fangyan_tts_tpu.models.hift import CausalHiFT
from fangyan_tts_tpu.models.llm import CosyVoice3LM
from torch_port_util import both, np_params, to_jax

import jax

JC, TC = both()
REPO = Path(__file__).resolve().parent.parent


def _params():
    t = jnp.zeros((1, 8), jnp.int32)
    llm = np_params(CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t, gain=0.5)
    flow = np_params(CausalMaskedDiffWithDiT(JC.flow), 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                     jnp.asarray([16]), jnp.zeros((1, 192)), jax.random.PRNGKey(0))
    hift = np_params(CausalHiFT(JC.hift), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    hift["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)  # voiced frames
    return llm, flow, hift


def _pair():
    llm, flow, hift = _params()
    jtts = JaxTTS(JC, to_jax(llm), to_jax(flow), to_jax(hift), dtype=jnp.float32)
    ttts = TorchTTS(TC, llm_from_jax(llm, TC.llm), flow_from_jax(flow, TC.flow), hift_from_jax(hift, TC.hift),
                    dtype=torch.float32, device="cpu")
    return jtts, ttts


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _request():
    rng = np.random.default_rng(11)
    return dict(
        text=rng.integers(0, 300, 6).astype(np.int32),
        prompt_text=rng.integers(0, 300, 3).astype(np.int32),
        llm_prompt_speech_token=rng.integers(0, 50, 5).astype(np.int32),
        flow_prompt_speech_token=rng.integers(0, 50, 5).astype(np.int32),
        prompt_speech_feat=(rng.standard_normal((10, 80)) * 0.5).astype(np.float32),
        flow_embedding=rng.standard_normal(192).astype(np.float32),
        min_token_text_ratio=2, max_token_text_ratio=4,
    )


def test_tokens_equal(pair):
    jtts, ttts = pair
    r = _request()
    args = (r["text"], r["prompt_text"], r["llm_prompt_speech_token"], 2, 4)
    want, got = jtts.generate_tokens(*args), ttts.generate_tokens(*args)
    assert len(want) >= 12
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("speed", [1.0, 1.1])
def test_tts_wav(pair, speed):
    jtts, ttts = pair
    want = next(jtts.tts(**_request(), speed=speed))["tts_speech"]
    got = next(ttts.tts(**_request(), speed=speed))["tts_speech"]
    assert got.dtype == np.float32 and got.shape == want.shape and len(want) % 480 == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.abs(want).max() > 1e-2


def _batch_request():
    rng = np.random.default_rng(4)
    return dict(
        texts=[rng.integers(0, 300, n).astype(np.int32) for n in (4, 7, 5)],
        prompt_text=rng.integers(0, 300, 3).astype(np.int32),
        llm_prompt_speech_token=rng.integers(0, 50, 5).astype(np.int32),
        flow_prompt_speech_token=rng.integers(0, 50, 5).astype(np.int32),
        prompt_speech_feat=(rng.standard_normal((10, 80)) * 0.5).astype(np.float32),
        flow_embedding=rng.standard_normal(192).astype(np.float32),
        min_token_text_ratio=2, max_token_text_ratio=4,
    )


@pytest.mark.parametrize("quantized", [False, True])
def test_batch_synthesize(quantized):
    """Three ragged texts sharing one voice prompt; quantized: the LLM in
    int8 with an int4 MLP and the DiT in int8, on both sides."""
    jtts, ttts = _pair()
    if quantized:
        for tts in (jtts, ttts):
            tts.quantize_llm(int4_mlp=True)
            tts.quantize_flow()
        assert ttts.llm.llm.layers[0].mlp.gate_up_proj.bits == 4
        assert ttts.flow.estimator.blocks[0].ff_0.kernel_q.dtype == torch.int8
    want = jtts.batch_synthesize(**_batch_request())
    got = ttts.batch_synthesize(**_batch_request())
    assert len(got) == len(want) == 3
    n_tokens = [len(w) // (2 * 480) for w in want]
    assert len(set(n_tokens)) > 1 and min(n_tokens) >= 8  # ragged rows, each past its min length
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and len(w) % 960 == 0  # equal token counts
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
        assert np.abs(w).max() > 1e-2


def test_quantize_llm_is_idempotent_as_in_jax():
    """quantize_llm(int4_mlp=True) after quantize_llm() changes nothing, on
    both sides: the int4 configuration needs a fresh instance."""
    jtts, ttts = _pair()
    for tts in (jtts, ttts):
        tts.quantize_llm()
        tts.quantize_llm(int4_mlp=True)
        assert tts.cfg.llm.qwen.quant_int8 and not tts.cfg.llm.qwen.quant_int4_mlp
        tts.quantize_flow()
        tts.quantize_flow()
        assert tts.cfg.flow.dit.quant_int8
    assert ttts.llm.llm.layers[0].mlp.down_proj.bits == 8
    assert ttts.flow.estimator.blocks[0].attn.to_qkv.kernel_q.dtype == torch.int8


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fangyan_tts_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'fangyan_tts_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'fangyan_tts_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'fangyan_tts_torch.runtime.grpc_server' in sys.modules\n"
        "v12 = ('models.conformer', 'models.unet_decoder', 'models.flow_xvec', 'models.llm_v1',\n"
        "       'models.llm_v1_decode', 'infer.tts_v12', 'utils.common')\n"
        "assert all('fangyan_tts_torch.' + m in sys.modules for m in v12)\n"
        "slice13 = ('cli.generate_dialect_dataset', 'cli.generate_dialect_dataset_dashscope',\n"
        "           'cli.generate_emotion_dataset', 'cli.generate_emotional_dataset_aliyun', 'cli.generate_esd_dataset',\n"
        "           'cli.doubao_tts', 'cli.compare_inference', 'cli.dialect_inference_test', 'cli.evaluate',\n"
        "           'cli.prepare_model_dir', 'runtime.token2wav_asr_server', 'runtime.disaggregated',\n"
        "           'tokenizer.parity', 'utils.profiling', 'utils.common')\n"
        "assert all('fangyan_tts_torch.' + m in sys.modules for m in slice13)\n"
        "slice14 = ('cli.export', 'models.subsampling', 'example', 'webui')\n"
        "assert all('fangyan_tts_torch.' + m in sys.modules for m in slice14)\n"
        "slice17 = ('parallel', 'parallel.mesh', 'parallel.sharding', 'parallel.comm', 'parallel.launch',\n"
        "           'parallel.dryrun')\n"
        "assert all('fangyan_tts_torch.' + m in sys.modules for m in slice17)\n"
        "print(len([m for m in sys.modules if m.startswith('fangyan_tts_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_port_imports_without_optional_packages():
    """The port imports, and serves the byte tokenizer, with jax, flax,
    regex, msgpack, transformers, tiktoken, grpc and protobuf unimportable
    (a CUDA host needs none of them; runtime/ imports grpc and protobuf only
    to serve or call); a tokenizer directory then raises, as in the JAX
    package, and so does the v1 whisper-style tokenizer (tiktoken is
    imported only to build one), while get_tokenizer without a rank file
    gives the byte tokenizer."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'regex', 'msgpack', 'transformers', 'tiktoken', 'fangyan_tts_tpu', 'grpc',\n"
        "             'google.protobuf'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, warnings\n"
        "import fangyan_tts_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'fangyan_tts_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from fangyan_tts_torch.runtime import grpc_client, grpc_server, http_server\n"
        "from fangyan_tts_torch.infer.textnorm import is_only_punctuation, text_normalize\n"
        "from fangyan_tts_torch.tokenizer import WhisperStyleTokenizer, get_qwen_tokenizer, get_tokenizer\n"
        "from fangyan_tts_torch.api import CosyVoice, CosyVoice2\n"
        "from fangyan_tts_torch.infer.tts_v12 import CosyVoice2TTS, CosyVoiceV1TTS\n"
        "warnings.simplefilter('ignore')\n"
        "tok = get_qwen_tokenizer(None)\n"
        "assert tok.encode('<|endofprompt|>a') == [259, 97]\n"
        "assert type(get_tokenizer(True, None)).__name__ == 'ByteFallbackTokenizer'\n"
        "try:\n"
        "    WhisperStyleTokenizer('ranks.tiktoken')\n"
        "    raise AssertionError('the v1 tokenizer built without tiktoken')\n"
        "except ImportError:\n"
        "    pass\n"
        "assert is_only_punctuation('。！')\n"
        "assert text_normalize('3.5%', list, split=False) == 'three point five percent'\n"
        "try:\n"
        "    get_qwen_tokenizer('some_tokenizer_dir')\n"
        "except ImportError:\n"
        "    print('tokenizer dir raises')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "tokenizer dir raises"


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    from fangyan_tts_torch import api
    from fangyan_tts_torch.infer import frontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchTTS.random_init(TC)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchTTS.random_init(TC, device="cuda")
    # asked for, the CPU runs every mode, streaming included (no CUDA tensor on that path)
    cpu_tts = TorchTTS.random_init(TC, dtype=torch.float32, device="cpu")
    chunks = list(cpu_tts.tts(source_speech_token=np.arange(40, dtype=np.int32) % 50, stream=True))
    assert len(chunks) >= 2 and all(c["tts_speech"].dtype == np.float32 for c in chunks)
    with pytest.raises(RuntimeError, match="CUDA"):
        frontend.Frontend(None, TC)
    for make in (frontend.make_campplus_fn, frontend.make_s3_fn):
        with pytest.raises(RuntimeError, match="CUDA"):
            make({})
    for entry in (api.CosyVoice3, api.AutoModel):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(str(tmp_path))  # before any checkpoint is looked for
    # the card runs bf16 and float32 (the kernels' two routes); any other dtype is refused, not run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        TorchTTS(TC, {}, {}, {}, dtype=torch.float16, device="cuda")


def _cli_cases(tmp_path) -> dict:
    """(module, argv) of each model-loading CLI with everything but a device."""
    d = tmp_path / "model"
    d.mkdir()
    wav = tmp_path / "p.wav"
    wav.write_bytes(b"RIFF")
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "hunan.txt").write_text("你好。\n", encoding="utf-8")
    lst = tmp_path / "meta.lst"
    lst.write_text(f"u|提示。|{wav}|你好。\n", encoding="utf-8")
    return {
        "generate_dialect_dataset": ("cli.generate_dialect_dataset", [
            "--backend", "cuda", "--mode", "hunan", "--input-dir", str(tmp_path / "in"), "--output-dir",
            str(tmp_path / "out"), "--model-dir", str(d)]),
        "compare_inference": ("cli.compare_inference", ["--pretrained_dir", str(d), "--prompt_wav", str(wav),
                                                        "--output_dir", str(tmp_path / "cmp")]),
        "dialect_inference_test": ("cli.dialect_inference_test", ["--pretrained_dir", str(d), "--prompt_wav",
                                                                  str(wav), "--output_dir", str(tmp_path / "dia")]),
        "evaluate": ("cli.evaluate", ["--model_dir", str(d), "--eval_list", str(lst), "--output_dir",
                                      str(tmp_path / "ev"), "--asr", "none"]),
        "token2wav_asr_server": ("runtime.token2wav_asr_server", ["--model_dir", str(d), "--asr", "echo"]),
    }


@pytest.mark.parametrize("cli", ["generate_dialect_dataset", "compare_inference", "dialect_inference_test",
                                 "evaluate", "token2wav_asr_server"])
def test_new_clis_default_to_cuda(monkeypatch, tmp_path, cli):
    """Each model-loading CLI of the dataset-generation / evaluation slice
    runs on CUDA unless --device cpu is given: without a card it raises
    before any model is built (as every port entry point does)."""
    import importlib

    module, argv = _cli_cases(tmp_path)[cli]
    main = importlib.import_module(f"fangyan_tts_torch.{module}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        main(argv)
    with pytest.raises(SystemExit):  # --device is a flag of each of them
        main([*argv, "--device"])


def test_generator_text_raises():
    """A text generator (the bistream route), which raised NotImplementedError
    before the streaming slice was ported, now runs: stream=False vocodes
    the bistream decode's tokens, silent runs suppressed
    (tests/test_torch_stream.py holds the tokens and the wavs against the
    JAX package, offline and streaming). LLM gain 2, whose decode stops
    (at gain 0.5 it runs to the 1,500-token cap)."""
    from fangyan_tts_torch.infer.bistream import inference_bistream
    from fangyan_tts_torch.infer.tts import suppress_silent_runs

    _, flow, hift = _params()
    t = jnp.zeros((1, 8), jnp.int32)
    llm = np_params(CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t, gain=2.0)
    ttts = TorchTTS(TC, llm_from_jax(llm, TC.llm), flow_from_jax(flow, TC.flow), hift_from_jax(hift, TC.hift),
                    dtype=torch.float32, device="cpu")
    r = _request()
    gen = lambda: (np.asarray(t, np.int32) for t in ([5, 6, 7, 8, 9], [7]))
    wav = next(ttts.tts(**dict(r, text=gen())))["tts_speech"]
    tokens = suppress_silent_runs(np.asarray(list(inference_bistream(
        ttts.llm, gen(), r["prompt_text"], r["llm_prompt_speech_token"])), np.int32))
    assert wav.dtype == np.float32 and 0 < len(tokens) < 1500 and len(wav) == len(tokens) * 2 * 480
    assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-2


@pytest.mark.parametrize("sub, field, value", [
    ("qwen", "fused_decode_attention", False), ("qwen", "use_pallas_decode_attention", True),
])
def test_unported_options_raise(sub, field, value):
    """A JAX-package-only option set away from its default is refused, not
    ignored."""
    cfg = replace(TC, llm=replace(TC.llm, qwen=replace(TC.llm.qwen, **{field: value})))
    with pytest.raises(NotImplementedError, match=field):
        TorchTTS.random_init(cfg, dtype=torch.float32, device="cpu")


def test_wrappers_count_no_cpu_launches():
    tdevice.launches.clear()
    x = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    tfa.chunk_flash_attention(x, x, x, torch.tensor([5], dtype=torch.int32), 4)
    ck = torch.zeros((2, 1, 16, 2, 64), dtype=torch.bfloat16)
    q, kv = torch.zeros((1, 14, 64), dtype=torch.bfloat16), torch.zeros((1, 2, 64), dtype=torch.bfloat16)
    tda.decode_attention(q, kv, kv, ck, ck.clone(), torch.tensor([3], dtype=torch.int32), torch.zeros((1, 16)), 1)
    ti4.int4_matmul(torch.zeros((3, 64), dtype=torch.bfloat16), torch.zeros((32, 128), dtype=torch.int8), torch.ones(128))
    assert tdevice.launches == {}


def test_from_jax_rejects_mismatched_trees():
    llm, _, hift = _params()
    extra = dict(llm, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unused"):
        llm_from_jax(extra, TC.llm)
    missing = {k: v for k, v in hift.items() if k != "conv_post"}
    with pytest.raises(ValueError, match="missing"):
        hift_from_jax(missing, TC.hift)
    wrong = dict(hift, conv_pre={"kernel": np.zeros((4, 80, 64), np.float32), "bias": hift["conv_pre"]["bias"]})
    with pytest.raises(ValueError, match="shape"):
        hift_from_jax(wrong, TC.hift)
