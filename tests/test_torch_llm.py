"""fangyan_tts_torch.models.{qwen2,llm} against the JAX package with the
same weights (carried by models/from_jax.llm_from_jax), float32 models:
prefill logits rel <= 2e-4 with equal argmax; teacher-forced decode logits
(bf16 on both sides: decode runs in the cache dtype) within atol 2e-2 with
equal argmax; greedy tokens bit-equal over a whole generate_speech_tokens
run with one left-padded row among B=2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.models import llm as tllm
from fangyan_tts_torch.models import qwen2 as tq
from fangyan_tts_torch.models.from_jax import llm_from_jax
from fangyan_tts_tpu.data.lm_plan import build_prompt_plan, pad_plans_left
from fangyan_tts_tpu.models import qwen2 as jq
from fangyan_tts_tpu.models.llm import CosyVoice3LM, generate_speech_tokens
from torch_port_util import both, np_params, to_jax

JC, TC = both()
TP, CACHE = 16, 48
GAIN = 0.5  # weight scale: logits of order one, attention not saturated


def _models(seed=0):
    jm = CosyVoice3LM(JC.llm, dtype=jnp.float32)
    t = jnp.zeros((1, 4), jnp.int32)
    p = np_params(jm, seed, t, t, jnp.asarray([4]), t, gain=GAIN)
    tm = tllm.CosyVoice3LM(TC.llm, dtype=torch.float32)
    tm.load_state_dict(llm_from_jax(p, TC.llm), strict=True)
    return jm, to_jax(p), tm.eval()


def _batch():
    """Two prompts, the second shorter, left-padded to TP."""
    rng = np.random.default_rng(7)
    plans = [build_prompt_plan(JC.llm, rng.integers(0, 300, n).tolist(), rng.integers(0, 50, m).tolist())
             for n, m in ((9, 4), (5, 2))]
    return pad_plans_left(plans, length=TP)


def _prefill_and_decode(jm, jp, tm, tokens, cache_dtype="bfloat16"):
    batch = _batch()
    src, ids, lens = (batch[k] for k in ("src", "ids", "lengths"))
    bound = jm.bind({"params": jp})
    cache = jq.init_cache(JC.llm.qwen, 2, CACHE, dtype=getattr(jnp, cache_dtype))
    h, cache = bound.prefill_leftpad(jnp.asarray(src), jnp.asarray(ids), jnp.asarray(lens), cache)
    jl = [np.asarray(bound.llm_decoder(h), np.float32)]
    tcache = tq.init_cache(TC.llm.qwen, 2, CACHE, dtype=getattr(torch, cache_dtype))
    with torch.no_grad():
        th = tm.prefill_leftpad(torch.from_numpy(src), torch.from_numpy(ids), torch.from_numpy(lens), tcache)
        tl = [tm.decode_logits(th).float().numpy()]
    start = (TP - lens).astype(np.int32)
    for i, tok in enumerate(tokens):
        tok_b = np.asarray([tok, (tok * 7) % 50], np.int32)
        pos = (lens + i)[:, None].astype(np.int32)
        lg, cache = bound.decode_step(jnp.asarray(tok_b), jnp.asarray(pos), jnp.asarray(start), TP + i + 1, cache)
        jl.append(np.asarray(lg, np.float32))
        with torch.no_grad():
            tl.append(tm.decode_step(torch.from_numpy(tok_b), torch.from_numpy(pos), torch.from_numpy(start),
                                     TP + i + 1, tcache).float().numpy())
    return jl, tl, cache, tcache


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_prefill_and_teacher_forced_decode(cache_dtype):
    """bf16 cache (the production dtype): decode logits within atol 2e-2.
    A float32 cache on both sides takes bf16 rounding out, so the decode
    logic is held to the prefill's rel 2e-4."""
    jm, jp, tm = _models()
    jl, tl, jcache, tcache = _prefill_and_decode(jm, jp, tm, [3, 17, 41, 8, 29], cache_dtype)
    rel = np.abs(tl[0] - jl[0]).max() / np.abs(jl[0]).max()
    assert rel <= 2e-4, rel
    np.testing.assert_array_equal(tl[0].argmax(-1), jl[0].argmax(-1))
    for a, b in zip(tl[1:], jl[1:]):
        if cache_dtype == "bfloat16":
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-2)
        else:
            assert np.abs(a - b).max() / np.abs(b).max() <= 2e-4
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    # the prefill rows of the cache agree (bf16 storage of float32 K/V)
    np.testing.assert_allclose(tcache["k"][:, :, :TP].float().numpy(), np.asarray(jcache["k"][:, :, :TP], np.float32),
                               rtol=0, atol=2e-2)
    assert int(tcache["index"][0]) == int(jcache["index"]) == TP + 5


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_bit_equal(seed):
    jm, jp, tm = _models(seed)
    batch = _batch()
    min_lens, max_lens = np.asarray([3, 5], np.int32), np.asarray([24, 20], np.int32)
    res = generate_speech_tokens(jm, jp, *(jnp.asarray(batch[k]) for k in ("src", "ids", "lengths")),
                                 jnp.asarray(min_lens), jnp.asarray(max_lens), jax.random.PRNGKey(0),
                                 max_new_tokens=32, cache_len=CACHE)
    got = tllm.generate_speech_tokens(tm, *(torch.from_numpy(batch[k]) for k in ("src", "ids", "lengths")),
                                      torch.from_numpy(min_lens), torch.from_numpy(max_lens),
                                      torch.Generator().manual_seed(0), max_new_tokens=32, cache_len=CACHE)
    np.testing.assert_array_equal(got.num_tokens.numpy(), np.asarray(res.num_tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(res.tokens))
    assert (got.num_tokens.numpy() >= min_lens).all()
