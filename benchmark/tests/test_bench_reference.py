"""The frozen float32 references agree with the system's plain CPU path at a
tiny size, on one state dict made by the benchmark."""

import numpy as np
import pytest
import torch

from benchmark.harness import Cell
from benchmark.systems import cosyvoice3 as sysmod
from conftest import tiny_config


@pytest.fixture(scope="module")
def setup():
    c = tiny_config(Cell("cv3.datagen_b16").config)
    w = sysmod.make_weights(c, 2**31 + 99, torch.device("cpu"), torch.float32)
    refs = {}
    for name, ctor in sysmod.reference_models(c).items():
        m = ctor()
        m.load_state_dict(w[name], strict=True)
        refs[name] = m.eval()
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    tts = CosyVoice3TTS(sysmod.port_config(c), w["llm"], w["flow"], w["hift"], dtype=torch.float32, device="cpu")
    return c, refs, tts


def test_lm_logits(setup):
    from fangyan_tts_torch.data.lm_plan import build_prompt_plan
    from fangyan_tts_torch.models import qwen2

    c, refs, tts = setup
    rng = np.random.default_rng(1)
    text, served = rng.integers(0, 300, 9), rng.integers(0, 6561, 12)
    plan = build_prompt_plan(tts.cfg.llm, text.tolist())
    src = torch.tensor(np.concatenate([plan.src, np.ones(11, np.int32)]))[None]
    ids = torch.tensor(np.concatenate([plan.ids, served[:-1]]))[None]
    with torch.no_grad():
        x = tts.llm.embed_plan(src, ids)
        t = x.shape[1]
        h = tts.llm.llm(x, torch.arange(t)[None], qwen2.causal_attn_bias(t))
        want = tts.llm.decode_logits(h)[0, len(plan.ids) - 1:]
    got = refs["llm"].served_logits(text, np.zeros(0, np.int64), served)
    assert got.shape == want.shape == (12, 6761)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_flow_mel(setup):
    c, refs, tts = setup
    rng = np.random.default_rng(2)
    prompt, tokens = rng.integers(0, 6561, 10), rng.integers(0, 6561, 17)
    feat = rng.standard_normal((20, 80)).astype(np.float32)
    emb = rng.standard_normal(192).astype(np.float32)
    want = tts.token2mel(tokens, prompt, feat, emb)
    got = refs["flow"].mel(np.concatenate([prompt, tokens]), feat, emb)
    assert got.shape == (54, 80)
    np.testing.assert_allclose(got[20:].numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [0, 50])
def test_flow_mel_chunk_mask(setup, chunk):
    from fangyan_tts_torch.models.flow import cfm_solve, fixed_cfm_noise

    c, refs, tts = setup
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 6561, 60)
    feat = rng.standard_normal((20, 80)).astype(np.float32)
    emb = rng.standard_normal(192).astype(np.float32)
    with torch.no_grad():
        mu, spks, conds, mel_len = tts.flow.prepare_inference(
            torch.tensor(tokens[None]), torch.tensor([60]), torch.tensor(feat[None]), torch.tensor([20]),
            torch.tensor(emb[None]))
        z = torch.from_numpy(fixed_cfm_noise())[:, :120]
        want = cfm_solve(tts.cfg.flow, tts.flow.estimator, z, mu, spks, conds, mel_len, streaming=chunk > 0)[0]
    got = refs["flow"].mel(tokens, feat, emb, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_vocoder(setup):
    c, refs, tts = setup
    mel = np.random.default_rng(4).standard_normal((40, 80)).astype(np.float32) * 2 - 4
    want = tts.vocode(mel)
    got = refs["hift"].audio(mel).numpy()
    assert got.shape == want.shape == (40 * 480,)
    keep = (40 - sysmod.TAIL_FRAMES) * 480  # the last frames see the padding the program adds
    np.testing.assert_allclose(got[:keep], want[:keep], rtol=1e-3, atol=1e-5)


def test_v3_stream_equals_the_chunk_masked_whole(setup):
    """The program's stream (the vc route: the tokens given) against the
    reference's chunk-masked flow and the vocoder over the target's mel."""
    c, refs, tts = setup
    rng = np.random.default_rng(5)
    prompt, tokens = rng.integers(0, 6561, 10), rng.integers(0, 6561, 70)
    feat = rng.standard_normal((20, 80)).astype(np.float32)
    emb = rng.standard_normal(192).astype(np.float32)
    chunks = [o["tts_speech"] for o in tts.tts(flow_embedding=emb, flow_prompt_speech_token=prompt,
                                               prompt_speech_feat=feat, source_speech_token=tokens, stream=True)]
    assert len(chunks) > 2
    mel = refs["flow"].mel(np.concatenate([prompt, tokens]), feat, emb, chunk=c["flow"]["dit"]["static_chunk_size"])
    want = refs["hift"].audio(mel[20:]).numpy()
    np.testing.assert_allclose(np.concatenate(chunks), want, rtol=1e-3, atol=2e-5)


@pytest.fixture(scope="module")
def setup_v2():
    from fangyan_tts_torch.config import HiFTConfig, LLMConfig, QwenConfig
    from fangyan_tts_torch.infer.tts_v12 import CosyVoice2TTS

    from benchmark.systems import cosyvoice2 as v2
    from benchmark.systems.cosyvoice3 import _pick

    c = tiny_config(Cell("cv2.stream_c8").config)
    w = sysmod.make_weights(c, 2**31 + 98, torch.device("cpu"), torch.float32, v2.reference_models(c))
    refs = {}
    for name, ctor in v2.reference_models(c).items():
        m = ctor()
        m.load_state_dict(w[name], strict=True)
        refs[name] = m.eval()
    flow_kw = {k: tuple(v) if isinstance(v, list) else v for k, v in c["flow"].items() if k != "in_channels"}
    tts = CosyVoice2TTS(_pick(LLMConfig, c, qwen=_pick(QwenConfig, c)), w["llm"], flow_kw, w["flow"],
                        _pick(HiFTConfig, c["hift"]), w["hift"], dtype=torch.float32, device="cpu")
    return c, refs, tts


def test_v2_lm_logits(setup_v2):
    from fangyan_tts_torch.models import qwen2

    c, refs, tts = setup_v2
    rng = np.random.default_rng(6)
    text, prompt_speech, served = rng.integers(0, 300, 7), rng.integers(0, 6561, 5), rng.integers(0, 6561, 9)
    plan = tts._plan(text, prompt_speech)
    src = torch.tensor(np.concatenate([plan.src, np.ones(8, np.int32)]))[None]
    ids = torch.tensor(np.concatenate([plan.ids, served[:-1]]))[None]
    with torch.no_grad():
        x = tts.llm.embed_plan(src, ids)
        t = x.shape[1]
        want = tts.llm.decode_logits(tts.llm.llm(x, torch.arange(t)[None], qwen2.causal_attn_bias(t)))[0, len(plan.ids) - 1:]
    got = refs["llm"].served_logits(text, prompt_speech, served)
    assert got.shape == want.shape == (9, 6564)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("streaming,finalize", [(True, False), (False, True)])
def test_v2_flow_mel(setup_v2, streaming, finalize):
    c, refs, tts = setup_v2
    rng = np.random.default_rng(7)
    prompt, tokens = rng.integers(0, 6561, 10), rng.integers(0, 6561, 53)
    feat = rng.standard_normal((20, 80)).astype(np.float32)
    emb = rng.standard_normal(192).astype(np.float32)
    want = tts.token2mel(tokens, prompt, feat, emb, token_offset=0, streaming=streaming, finalize=finalize)
    got = refs["flow"].mel(np.concatenate([prompt, tokens]), feat, emb, streaming, finalize)[20:].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_v2_stream_hop_by_hop(setup_v2):
    """The program's CosyVoice2 stream (the vc route) against the
    reference's hop-by-hop token2wav of the same tokens."""
    from benchmark.reference.v2_stream import stream_audio

    c, refs, tts = setup_v2
    rng = np.random.default_rng(8)
    prompt, tokens = rng.integers(0, 6561, 10), rng.integers(0, 6561, 80)
    feat = rng.standard_normal((20, 80)).astype(np.float32)
    emb = rng.standard_normal(192).astype(np.float32)
    chunks = [o["tts_speech"] for o in tts.tts(flow_embedding=emb, flow_prompt_speech_token=prompt,
                                               prompt_speech_feat=feat, source_speech_token=tokens, stream=True)]
    assert len(chunks) >= 3
    want = stream_audio(refs["flow"], refs["hift"], prompt, feat, emb, tokens)
    got = np.concatenate(chunks)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-5)
