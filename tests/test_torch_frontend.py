"""The port's prompt frontend against the JAX package's, float32 on the
CPU, with the same weights (the JAX trees made by campplus_params_from_torch
/ s3_params_from_torch from the tests/oracles modules, carried into the port
by campplus_from_jax / s3_from_jax):
- CAM++ at tests/test_campplus_parity.py's TINY configuration, with an odd
  T and a T whose last 100-frame segment is partial: atol 2e-4, rtol 2e-3
  (that test's limits);
- S3 at tests/test_s3tokenizer_parity.py's TINY dims: code lengths and the
  codes on the valid frames bit-equal, and the codes unchanged by padding;
- `Frontend`: the dict of every frontend_* builder, from a 24 kHz wav file
  and from a 16 kHz numpy prompt, through tiny float32 CAM++ / S3 on both
  sides: tokens equal, feats within 1e-3, the x-vector within CAM++'s
  limits;
- a spk2info.pt saved by either package loads in the other."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch import config as tcfg
from fangyan_tts_torch.data.audio import write_wav
from fangyan_tts_torch.infer import frontend as tfe
from fangyan_tts_torch.models.campplus import CAMPPlus as TorchCAMPPlus
from fangyan_tts_torch.models.from_jax import campplus_from_jax, s3_from_jax
from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3 as TorchS3
from fangyan_tts_torch.tokenizer import ByteFallbackTokenizer as TorchBytes
from fangyan_tts_tpu import config as jcfg
from fangyan_tts_tpu.infer import frontend as jfe
from fangyan_tts_tpu.models.campplus import CAMPPlus
from fangyan_tts_tpu.models.convert import campplus_params_from_torch, s3_params_from_torch
from fangyan_tts_tpu.models.s3tokenizer import S3TokenizerV3
from fangyan_tts_tpu.tokenizer import ByteFallbackTokenizer as JaxBytes
from torch_port_util import FE_CAMP, FE_S3, campplus_kwargs, campplus_oracle, s3_kwargs, s3_oracle

XVEC_ATOL, XVEC_RTOL = 2e-4, 2e-3  # tests/test_campplus_parity.py
FEAT_ATOL = 1e-3

CAMP_TINY = dict(feat_dim=16, embedding_size=8, growth_rate=4, bn_size=4, init_channels=16, block_layers=(2, 2, 2))
S3_TINY = dict(n_mels=16, n_state=32, n_head=4, n_layer=2, kernel_size=7)


@pytest.mark.parametrize("t, seed", [(173, 3), (150, 5), (97, 7)])
def test_campplus(t, seed):
    params = campplus_params_from_torch(campplus_oracle(CAMP_TINY, seed).state_dict(), CAMP_TINY["block_layers"])
    jkw, tkw = campplus_kwargs(CAMP_TINY)
    x = np.random.default_rng(seed).standard_normal((2, t, 16)).astype(np.float32)
    want = np.asarray(CAMPPlus(**jkw).apply({"params": params}, jnp.asarray(x)))
    model = TorchCAMPPlus(**tkw).eval()
    model.load_state_dict(campplus_from_jax(params, **tkw))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_allclose(got, want, atol=XVEC_ATOL, rtol=XVEC_RTOL)


def _s3_pair(seed: int):
    params, _ = s3_params_from_torch(s3_oracle(S3_TINY, seed).state_dict())
    kw = s3_kwargs(S3_TINY)
    model = TorchS3(**kw).eval()
    model.load_state_dict(s3_from_jax(params, **kw))
    return (lambda mel, n: S3TokenizerV3(**kw).apply({"params": params}, jnp.asarray(mel), jnp.asarray(n))), model


def test_s3_codes_bit_equal():
    jfn, model = _s3_pair(11)
    mel = np.random.default_rng(1).standard_normal((3, 16, 40)).astype(np.float32)
    mel_len = np.asarray([40, 25, 3], np.int32)
    want_codes, want_len = (np.asarray(a) for a in jfn(mel, mel_len))
    with torch.no_grad():
        codes, code_len = (a.numpy() for a in model(torch.from_numpy(mel), torch.from_numpy(mel_len)))
    assert codes.dtype == code_len.dtype == np.int32
    np.testing.assert_array_equal(code_len, want_len)
    np.testing.assert_array_equal(code_len, [10, 7, 1])
    for b, n in enumerate(want_len):
        np.testing.assert_array_equal(codes[b, :n], want_codes[b, :n])
    assert len(np.unique(codes[0])) > 3


def test_s3_padding_invariance():
    jfn, model = _s3_pair(13)
    mel = np.random.default_rng(2).standard_normal((1, 16, 28)).astype(np.float32)
    padded = np.concatenate([mel, np.zeros((1, 16, 36), np.float32)], axis=2)
    with torch.no_grad():
        a, la = model(torch.from_numpy(mel), torch.tensor([28]))
        b, lb = model(torch.from_numpy(padded), torch.tensor([28]))
    n = int(la[0])
    assert int(lb[0]) == n == 7
    np.testing.assert_array_equal(a[0, :n].numpy(), b[0, :n].numpy())
    want, _ = jfn(padded, np.asarray([28], np.int32))
    np.testing.assert_array_equal(b[0, :n].numpy(), np.asarray(want)[0, :n])


# ---------------------------------------------------------------- Frontend

def _jax_fns(camp_params, s3_params):
    jkw, _ = campplus_kwargs(FE_CAMP)
    cm, sm = CAMPPlus(**jkw), S3TokenizerV3(**s3_kwargs(FE_S3))
    camp = jax.jit(lambda p, f: cm.apply({"params": p}, f))
    s3 = jax.jit(lambda p, m, n: sm.apply({"params": p}, m, n))
    return (lambda f: camp(camp_params, f)), (lambda m, n: s3(s3_params, m, n))


@pytest.fixture(scope="module")
def frontends(tmp_path_factory):
    camp_params = campplus_params_from_torch(campplus_oracle(FE_CAMP, 21).state_dict(), FE_CAMP["block_layers"])
    s3_params, _ = s3_params_from_torch(s3_oracle(FE_S3, 22).state_dict())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtok, ttok = JaxBytes(), TorchBytes()
    jcamp, js3 = _jax_fns(camp_params, s3_params)
    jfront = jfe.Frontend(jtok, jcfg.CosyVoiceConfig(), jcamp, js3)
    _, tkw = campplus_kwargs(FE_CAMP)
    tfront = tfe.Frontend(ttok, tcfg.CosyVoiceConfig(),
                          tfe.make_campplus_fn(camp_params, device="cpu", dtype=torch.float32, **tkw),
                          tfe.make_s3_fn(s3_params, device="cpu", dtype=torch.float32, **s3_kwargs(FE_S3)),
                          device="cpu")
    d = tmp_path_factory.mktemp("prompts")
    rng = np.random.default_rng(8)
    t = np.arange(int(2.3 * 24000)) / 24000.0
    wav24 = (0.1 * rng.standard_normal(t.size) + 0.3 * np.sin(2 * np.pi * 180.0 * t)).astype(np.float32)
    write_wav(d / "prompt24k.wav", wav24, 24000)
    t16 = np.arange(int(3.7 * 16000)) / 16000.0  # over 3 s: the 5 s bucket
    wav16 = (0.1 * rng.standard_normal(t16.size) + 0.2 * np.sin(2 * np.pi * 260.0 * t16)).astype(np.float32)
    return jfront, tfront, {"file": str(d / "prompt24k.wav"), "numpy": wav16}, d


def _assert_inputs_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k.endswith("embedding"):
            np.testing.assert_allclose(g, w, atol=XVEC_ATOL, rtol=XVEC_RTOL, err_msg=k)
        elif k == "prompt_speech_feat":
            np.testing.assert_allclose(g, w, rtol=0, atol=FEAT_ATOL)
        else:
            assert g.dtype == w.dtype == np.int32, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("prompt", ["file", "numpy"])
def test_frontend_builders(frontends, prompt):
    jfront, tfront, prompts, _ = frontends
    wav = prompts[prompt]
    calls = {
        "zero_shot": lambda f: f.frontend_zero_shot("今天天气不错。", "提示文本。", wav),
        "cross_lingual": lambda f: f.frontend_cross_lingual("Hello there.", wav),
        "instruct2": lambda f: f.frontend_instruct2("你好。", "请用湖南话说。<|endofprompt|>", wav),
        "vc": lambda f: f.frontend_vc(prompts["numpy"][:20000], wav),
    }
    for name, call in calls.items():
        got, want = call(tfront), call(jfront)
        _assert_inputs_equal(got, want)
        if "llm_prompt_speech_token" in want:
            assert len(want["llm_prompt_speech_token"]) > 10 and 2 * len(want["flow_prompt_speech_token"]) == len(
                want["prompt_speech_feat"])


def test_frontend_text_and_generators(frontends):
    jfront, tfront, _, _ = frontends
    for text in ("2024年8月17日，气温3.5℃。然后呢？", "It rose 3.5%. Then it fell."):
        assert tfront.text_normalize(text) == jfront.text_normalize(text)
        assert tfront.text_normalize(text, split=False, text_frontend=False) == text
    gen_t = tfront.extract_text_token(iter(["你好", "世界"]))
    gen_j = jfront.extract_text_token(iter(["你好", "世界"]))
    assert hasattr(gen_t, "__next__")
    for a, b in zip(gen_t, gen_j, strict=True):
        np.testing.assert_array_equal(a, b)
    g = iter(["x"])
    assert tfront.text_normalize(g) == [g] and tfront.text_normalize(g, split=False) is g


def test_spk2info_interchange(frontends):
    jfront, tfront, prompts, d = frontends
    assert tfront.add_zero_shot_spk("提示文本。", prompts["file"], "spk_t")
    assert jfront.add_zero_shot_spk("提示文本。", prompts["file"], "spk_j")
    _assert_inputs_equal(tfront.spk2info["spk_t"], jfront.spk2info["spk_j"])
    tfront.save_spkinfo(d / "port_spk2info.pt")
    jfront.save_spkinfo(d / "jax_spk2info.pt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_from_port = jfe.Frontend(JaxBytes(), jcfg.CosyVoiceConfig(), spk2info=d / "port_spk2info.pt")
        t_from_jax = tfe.Frontend(TorchBytes(), tcfg.CosyVoiceConfig(), spk2info=d / "jax_spk2info.pt", device="cpu")
    for a, b in ((j_from_port.spk2info["spk_t"], tfront.spk2info["spk_t"]),
                 (t_from_jax.spk2info["spk_j"], jfront.spk2info["spk_j"])):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    # the saved speaker serves the zero-shot, sft and instruct builders in both
    _assert_inputs_equal(t_from_jax.frontend_zero_shot("再来一句。", "", "", zero_shot_spk_id="spk_j"),
                         jfront.frontend_zero_shot("再来一句。", "", "", zero_shot_spk_id="spk_j"))
    for f in (t_from_jax, jfront):
        f.spk2info["spk_j"]["embedding"] = f.spk2info["spk_j"]["flow_embedding"]
    _assert_inputs_equal(t_from_jax.frontend_sft("你好。", "spk_j"), jfront.frontend_sft("你好。", "spk_j"))
    _assert_inputs_equal(t_from_jax.frontend_instruct("你好。", "spk_j", "开心地说"),
                         jfront.frontend_instruct("你好。", "spk_j", "开心地说"))


def test_pad_bucket_equal():
    rng = np.random.default_rng(0)
    for n in (100, 48000, 48001, 16000 * 30, 16000 * 31):
        a = rng.standard_normal(n).astype(np.float32)
        (ga, na), (wa, wn) = tfe._pad_bucket(a, 16000), jfe._pad_bucket(a, 16000)
        assert na == wn
        np.testing.assert_array_equal(ga, wa)
