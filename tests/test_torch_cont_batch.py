"""Continuous batching of the streaming LLM decode in fangyan_tts_torch
(models/llm.ContState, decode_chunk_cont, the inserts; infer/llm_batch.
LLMScheduler) against the JAX package and against the port's own solo
decode, float32 on the CPU:

- decode_chunk_cont on the same inserted state as the JAX package's, rows
  joining at different depths, with float32 KV caches on both sides (as
  tests/test_torch_stream.py's test_decode_float32_cache, so that no
  request has to be chosen to avoid a bf16 near-tie): logits within 1e-4
  after every chunk, tokens equal;
- scheduler sessions (staggered, threaded, a batched prefill window, a
  cohort split, an abandoned stream) give the tokens of the port's solo
  decode_prefill + decode_chunk with the same generator seed: each row
  draws from its own generator in the solo order;
- tts(stream=True) routes through the scheduler;
- per-row generators leave the solo draws unchanged.
"""

import threading
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.data.lm_plan import pad_plans_left as t_pad
from fangyan_tts_torch.infer import llm_batch as lb
from fangyan_tts_torch.infer.llm_batch import LLMScheduler
from fangyan_tts_torch.infer.tts import CosyVoice3TTS as TorchTTS
from fangyan_tts_torch.infer.tts import silent_run_filter, stream_buckets
from fangyan_tts_torch.models import llm as tllm
from fangyan_tts_torch.models import qwen2 as tq
from fangyan_tts_torch.models.from_jax import flow_from_jax, hift_from_jax, llm_from_jax
from fangyan_tts_torch.ops import sampling
from fangyan_tts_tpu.data.lm_plan import build_prompt_plan, pad_plans_left
from fangyan_tts_tpu.infer.tts import CosyVoice3TTS as JaxTTS
from fangyan_tts_tpu.models import llm as jllm
from fangyan_tts_tpu.models import qwen2 as jq
from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT
from fangyan_tts_tpu.models.hift import CausalHiFT
from torch_port_util import both, configs, np_params, to_jax
import fangyan_tts_torch.config as tcfg

JC, TC = (replace(c, flow=replace(c.flow, dit=replace(c.flow.dit, static_chunk_size=50)),
                  hift=replace(c.hift, stream_noise_seconds=10)) for c in both())
RATIO = dict(min_token_text_ratio=6.0, max_token_text_ratio=6.0)
_jax_init_cache, _torch_init_cache = jq.init_cache, tq.init_cache


@pytest.fixture(scope="module")
def pair():
    """Greedy JAX and port models with the same weights (LLM gain 2)."""
    t = jnp.zeros((1, 8), jnp.int32)
    llm = np_params(jllm.CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t, gain=2.0)
    flow = np_params(CausalMaskedDiffWithDiT(JC.flow), 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                     jnp.asarray([16]), jnp.zeros((1, 192)), jax.random.PRNGKey(0))
    hift = np_params(CausalHiFT(JC.hift), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    jtts = JaxTTS(JC, to_jax(llm), to_jax(flow), to_jax(hift), dtype=jnp.float32)
    ttts = TorchTTS(TC, llm_from_jax(llm, TC.llm), flow_from_jax(flow, TC.flow), hift_from_jax(hift, TC.hift),
                    dtype=torch.float32, device="cpu")
    for tts in (jtts, ttts):
        tts.stream_window_tokens = 50
    return jtts, ttts


@pytest.fixture(scope="module")
def sampled():
    """A port model that samples (top-k 25, RAS), random weights."""
    cfg = configs(tcfg, greedy=False)
    return TorchTTS.random_init(cfg, dtype=torch.float32, device="cpu", seed=3)


def _texts(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 40, (8,)).astype(np.int32) for _ in range(n)]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _solo(tts, text, seed: int) -> np.ndarray:
    """The port's solo streaming decode (decode_prefill + decode_chunk, as
    _stream_tokens runs it) from a generator seeded `seed`, silent runs
    suppressed."""
    plan, tp, cache_len, min_len, max_len = stream_buckets(tts.cfg.llm, text, np.zeros(0, np.int32),
                                                           np.zeros(0, np.int32), **RATIO)
    b = t_pad([plan], length=tp)
    gen, keep, out = _gen(seed), silent_run_filter(), []
    with torch.inference_mode():
        st = tllm.decode_prefill(tts.llm, *(torch.from_numpy(b[k]) for k in ("src", "ids", "lengths")),
                                 torch.tensor([min_len]), torch.tensor([max_len]), cache_len)
        while not bool(st.done.all()) and st.i < max_len:
            st, chunk = tllm.decode_chunk(tts.llm, st, 32, tp, gen)
            out += [t for t in chunk[0].tolist() if t >= 0 and keep(t)]
    return np.asarray(out, np.int32)


def _drain(sched, h) -> np.ndarray:
    chunks = list(sched.stream(h))
    return np.concatenate(chunks) if chunks else np.zeros(0, np.int32)


def test_decode_chunk_cont_matches_jax(pair, monkeypatch):
    """The same rows inserted at the same slots on both sides (two into a
    width-3 state, a third after two chunks, so rows sit at different
    depths and write slots): after every 8-step chunk the logits agree
    within 1e-4 and the tokens are equal. float32 caches on both sides (the
    JAX prefill unjitted, so that no bf16 trace of it is reused)."""
    monkeypatch.setattr(jq, "init_cache", lambda cfg, b, n, dtype=None: _jax_init_cache(cfg, b, n, dtype=jnp.float32))
    monkeypatch.setattr(tq, "init_cache", lambda cfg, b, n, dtype=None, device=None:
                        _torch_init_cache(cfg, b, n, dtype=torch.float32, device=device))
    jtts, ttts = pair
    rng = np.random.default_rng(4)
    texts = [rng.integers(0, 300, 4).astype(np.int32) for _ in range(3)]
    n, tp, cache_len = 3, 64, 256
    plans = [build_prompt_plan(JC.llm, t.tolist(), []) for t in texts]
    lens = [(len(t) * 6, len(t) * 10) for t in texts]  # min, max: 24 and 40 tokens

    def prefill(rows):
        b = pad_plans_left([plans[r] for r in rows] + [plans[rows[0]]] * (n - len(rows)), length=tp)
        mins = [lens[r][0] for r in rows] + [0] * (n - len(rows))
        maxs = [lens[r][1] for r in rows] + [0] * (n - len(rows))
        js = jllm.decode_prefill.__wrapped__(jtts.llm, jtts.llm_params, *(jnp.asarray(b[k]) for k in
                                             ("src", "ids", "lengths")), jnp.asarray(mins), jnp.asarray(maxs),
                                             jax.random.PRNGKey(0), cache_len=cache_len)
        ts = tllm.decode_prefill(ttts.llm, *(torch.from_numpy(b[k]) for k in ("src", "ids", "lengths")),
                                 torch.tensor(mins), torch.tensor(maxs), cache_len)
        return js, ts

    def insert(jbig, tbig, rows, slots):
        js, ts = prefill(rows)
        pad = [-1] * (n - len(rows))
        keys = jnp.stack([jax.random.PRNGKey(r) for r in rows] + [jax.random.PRNGKey(0)] * len(pad))
        jbig = jllm.cont_insert_rows_masked(jllm.cont_empty(js, n) if jbig is None else jbig, js,
                                            jnp.asarray(slots + pad, jnp.int32), keys)
        tbig = tllm.cont_insert_rows_masked(tllm.cont_empty(ts, n) if tbig is None else tbig, ts, slots + pad,
                                            [_gen(r) for r in rows] + [None] * len(pad))
        return jbig, tbig

    jst, tst = insert(None, None, [0, 1], [2, 0])
    got, want = [], []
    for chunk in range(6):
        if chunk == 2:
            jst, tst = insert(jst, tst, [2], [1])
        np.testing.assert_allclose(tst.logits.numpy(), np.asarray(jst.logits), rtol=0, atol=1e-4)
        jst, jc = jllm.decode_chunk_cont(jtts.llm, jtts.llm_params, jst, 8, tp)
        tst, tc = tllm.decode_chunk_cont(ttts.llm, tst, 8, tp)
        want.append(np.asarray(jc))
        got.append(tc.numpy())
        np.testing.assert_array_equal(tst.done.numpy(), np.asarray(jst.done))
        np.testing.assert_array_equal(tst.i.numpy(), np.asarray(jst.i))
        np.testing.assert_array_equal(tst.cache["index"].numpy(), np.asarray(jst.cache["index"]))
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    np.testing.assert_array_equal(got, want)
    assert all((got[s] >= 0).sum() >= 24 for s in range(n))


def test_staggered_sessions_match_solo(sampled):
    """Round-robin in one thread: sessions joining at different depths,
    late ones on recycled slots, each equal to its solo decode; the shared
    chunks batch."""
    texts = _texts(0, 4)
    want = [_solo(sampled, texts[i], 100 + i) for i in range(4)]
    sched = LLMScheduler(sampled, width=2)
    got = [[] for _ in range(4)]
    open_s = lambda i: sched.stream(sched.open(texts[i], generator=_gen(100 + i), **RATIO))
    live, nxt = {0: open_s(0), 1: open_s(1)}, 2
    while live or nxt < 4:
        for i in list(live):
            try:
                got[i].append(next(live[i]))
            except StopIteration:
                del live[i]
                if nxt < 4:
                    live[nxt] = open_s(nxt)
                    nxt += 1
    for i in range(4):
        np.testing.assert_array_equal(np.concatenate(got[i]), want[i], err_msg=f"session {i}")
    assert sched.stats["rows"] / sched.stats["steps"] > 1.2, sched.stats
    assert not sched.sessions


def _clients(sched, texts, seeds, delays=None) -> list:
    got, errs = [None] * len(texts), []

    def client(i):
        try:
            if delays:
                time.sleep(delays[i])
            got[i] = _drain(sched, sched.open(texts[i], generator=_gen(seeds[i]), **RATIO))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(len(texts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs
    assert not any(t.is_alive() for t in ts)
    return got


def test_threaded_sessions_match_solo(sampled):
    texts = _texts(1, 3)
    want = [_solo(sampled, texts[i], 200 + i) for i in range(3)]
    got = _clients(LLMScheduler(sampled, width=3), texts, [200, 201, 202], delays=[0.0, 0.02, 0.04])
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"session {i}")


def _count_prefills(monkeypatch) -> list:
    calls = []
    inner = lb.decode_prefill

    def counting(model, src, *a, **k):
        calls.append(int(src.shape[0]))
        return inner(model, src, *a, **k)

    monkeypatch.setattr(lb, "decode_prefill", counting)
    return calls


def test_batched_prefill_window_aligns_sessions(sampled, monkeypatch):
    """Four opens within one 0.5 s window share one prefill at the group
    width and match their solo decodes."""
    texts = _texts(7, 4)
    want = [_solo(sampled, texts[i], 500 + i) for i in range(4)]
    calls = _count_prefills(monkeypatch)
    got = _clients(LLMScheduler(sampled, width=4, prefill_window_s=0.5), texts, [500 + i for i in range(4)])
    for i in range(4):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"session {i}")
    assert calls == [4], calls


def test_cohort_split_matches_solo(sampled, monkeypatch):
    """Opens in two bursts past a short window: two prefills, each at the
    full group width; every session matches its solo decode."""
    n = 6
    texts = _texts(11, n)
    want = [_solo(sampled, texts[i], 900 + i) for i in range(n)]
    calls = _count_prefills(monkeypatch)
    got = _clients(LLMScheduler(sampled, width=n, prefill_window_s=0.05), texts, [900 + i for i in range(n)],
                   delays=[0.0] * 3 + [0.4] * 3)
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"session {i}")
    assert len(calls) >= 2 and all(c == n for c in calls), calls


def test_abandoned_stream_releases_slot(sampled):
    """A stream dropped after one chunk frees its slot (at width 1 the next
    open would wait for ever otherwise), and so does close() of a stream
    never iterated."""
    text = _texts(5, 1)[0]
    sched = LLMScheduler(sampled, width=1)
    s1 = sched.stream(sched.open(text, generator=_gen(400), **RATIO))
    next(s1)
    s1.close()
    assert not sched.sessions
    sched.close(sched.open(text, generator=_gen(402), **RATIO))  # opened, never iterated
    assert not sched.sessions
    got = _drain(sched, sched.open(text, generator=_gen(401), **RATIO))
    np.testing.assert_array_equal(got, _solo(sampled, text, 401))


def test_step_error_reaches_every_session(sampled, monkeypatch):
    """An exception in a shared chunk reaches the leader and every session
    that waits on it, and each stream frees its slot."""
    sched = LLMScheduler(sampled, width=2, prefill_window_s=0.5)
    texts = _texts(3, 2)
    monkeypatch.setattr(lb, "decode_chunk_cont", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("kernel failed")))
    errs = []

    def client(i):
        try:
            _drain(sched, sched.open(texts[i], generator=_gen(i), **RATIO))
        except RuntimeError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert errs == ["kernel failed"] * 2 and not sched.sessions
    assert sorted(sum((g.free for g in sched.groups.values()), [])) == [0, 1]  # both rows free again


def test_tts_stream_routes_through_scheduler(pair):
    """tts(stream=True) with enable_batched_llm: the decode runs in the
    scheduler's chunks, and (greedy) the audio equals the solo stream's."""
    _, ttts = pair
    rng = np.random.default_rng(1)
    req = dict(text=rng.integers(0, 300, 3).astype(np.int32), flow_embedding=rng.standard_normal(192).astype(np.float32),
               min_token_text_ratio=20, max_token_text_ratio=20, stream=True)
    want = [c["tts_speech"] for c in ttts.tts(**req)]
    ttts.enable_batched_llm(width=2)
    try:
        got = [c["tts_speech"] for c in ttts.tts(**req)]
        assert ttts.llm_scheduler.stats["steps"] >= 2 and not ttts.llm_scheduler.sessions
    finally:
        ttts.llm_scheduler = None
    assert [len(g) for g in got] == [len(w) for w in want] and len(got) >= 3
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0, atol=1e-5)


def test_per_row_generators_leave_solo_draws():
    """One generator draws as before (the solo path); a list of generators
    gives row r what a one-row call with generator r gives."""
    rng = np.random.default_rng(0)
    logp = torch.log_softmax(torch.from_numpy(rng.standard_normal((3, 60)).astype(np.float32)) * 3, dim=-1)
    recent = torch.from_numpy(rng.integers(0, 60, (3, 10)).astype(np.int32))
    recent[0, :] = 7  # row 0's window is full of one token: RAS falls back if it draws 7
    allowed = torch.ones((3, 60), dtype=torch.bool)
    args = (logp, recent, recent >= 0, allowed)
    u = torch.rand((3, 25), generator=_gen(9))
    assert torch.equal(sampling._uniform((3, 25), _gen(9), "cpu"), u)
    batch = sampling.ras_sample(*args, [_gen(10), _gen(11), _gen(12)])
    for r in range(3):
        solo = sampling.ras_sample(*(a[r : r + 1] for a in args), _gen(10 + r))
        assert int(batch[r]) == int(solo[0])
    with pytest.raises(ValueError, match="generators"):
        sampling.ras_sample(*args, [_gen(1)])


def test_inserts_agree(sampled):
    """cont_insert (one row), cont_insert_rows (every row) and
    cont_insert_rows_masked (padding rows dropped) give the same state, and
    the rows they leave alone keep theirs."""
    tts = sampled
    texts = _texts(2, 2)
    plans = [stream_buckets(tts.cfg.llm, t, np.zeros(0, np.int32), np.zeros(0, np.int32), **RATIO)[0] for t in texts]
    b = t_pad(plans + [plans[0]], length=64)
    with torch.inference_mode():
        small = tllm.decode_prefill(tts.llm, *(torch.from_numpy(b[k]) for k in ("src", "ids", "lengths")),
                                    torch.tensor([48, 40, 0]), torch.tensor([48, 40, 0]), 256)
        gens = [_gen(1), _gen(2), None]

        def fresh():
            st = tllm.cont_empty(small, 4)
            st.cache["k"].fill_(7.0)  # rows no insert touches keep this
            return st

        masked = tllm.cont_insert_rows_masked(fresh(), small, [3, 1, -1], gens)
        rows = tllm.cont_insert_rows(fresh(), small, [3, 1], gens[:2])  # small rows 0 and 1
        row0 = small._replace(cache={k: v[:, :1] if k != "index" else v[:1] for k, v in small.cache.items()},
                              **{k: getattr(small, k)[:1] for k in ("logits", "recent", "done", "counts", "prompt_lens",
                                                                     "start_slots", "min_lens", "max_lens")})
        one = tllm.cont_insert(fresh(), row0, 3, gens[0])
    for st in (rows, masked):
        for name in ("logits", "recent", "done", "counts", "i", "prompt_lens", "start_slots", "min_lens", "max_lens"):
            assert torch.equal(getattr(st, name), getattr(masked, name)), name
        for k in ("k", "v", "index"):
            assert torch.equal(st.cache[k], masked.cache[k]), k
        assert st.generators[3] is gens[0] and st.generators[1] is gens[1]
    assert masked.done.tolist() == [True, False, True, False] and masked.max_lens.tolist() == [0, 40, 0, 48]
    assert bool((masked.cache["k"][:, [0, 2]] == 7.0).all()) and torch.equal(masked.cache["k"][:, 3], small.cache["k"][:, 0])
    for name in ("logits", "recent", "max_lens", "start_slots"):
        assert torch.equal(getattr(one, name)[3], getattr(masked, name)[3]), name
    assert torch.equal(one.cache["k"][:, 3], masked.cache["k"][:, 3]) and bool(one.done[1])
