"""Batched streaming in fangyan_tts_torch (infer/batch_stream.py:
BatchedStreamGroup, StreamScheduler; flow.prepare_inference(
padded_streaming=True); the per-row HiFT windows) against the JAX package
and against the port's own solo stream, float32 on the CPU, with a DiT whose
static chunk is the hop and a window of 100 tokens (hop 4 is the first on
the window), on the vc route, so that every session's tokens are given:

- prepare_inference(padded_streaming=True) on right-padded rows of
  different lengths: the JAX package's mu within 1e-3 and mel_len equal,
  and the frames below each row's length equal to the context-split form's;
- stream_window / finalize_window / rad_delta at B = 3 with different noise
  offsets, carries and valid lengths: the JAX package's within 1e-3 and
  three B = 1 calls within 1e-5;
- the group (lockstep feeds; finish and finish_many) and the scheduler
  (asynchronous client threads, open/feed/close churn with recycled slots,
  tts(stream=True) with both schedulers): each session's stream against the
  JAX package's solo tts(stream=True) of it within 1e-3, and against the
  port's solo stream within 1e-5. The group's chunks have the solo chunks'
  lengths; the scheduler returns the chunks its shared steps made for a
  session after its last feed in one piece from close(), so there only
  the whole stream is held.

The JAX tests assert that batched and solo streams are byte-equal. Here a
float32 product at M = 1 and at M = N may round differently on the CPU, so
the audio is held within 1e-5 of the solo stream (the port's solo stream
with flow_kv_stream off, the full-prefix young hops the group runs). No
batched chunk turned out bit-equal to its solo chunk: they differ by about
6e-8, and by up to 2.4e-6 on two hops of one slot. finish_many's tails are
within 7e-8 of finish()'s, and the young slot's is bit-equal (it runs
finish())."""

import threading
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.infer.batch_stream import BatchedStreamGroup, StreamScheduler
from fangyan_tts_torch.infer.tts import CosyVoice3TTS as TorchTTS
from fangyan_tts_torch.models import hift as thift
from fangyan_tts_torch.models.from_jax import flow_from_jax, hift_from_jax, llm_from_jax
from fangyan_tts_tpu.infer.tts import CosyVoice3TTS as JaxTTS
from fangyan_tts_tpu.models import hift as jhift
from fangyan_tts_tpu.models import llm as jllm
from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT
from fangyan_tts_tpu.models.hift import CausalHiFT
from torch_port_util import both, np_params, to_jax

JC, TC = (replace(c, flow=replace(c.flow, dit=replace(c.flow.dit, static_chunk_size=50)),
                  hift=replace(c.hift, stream_noise_seconds=10)) for c in both())
WINDOW = 100
JAX_ATOL, SOLO_ATOL = 1e-3, 1e-5
LENGTHS = [213, 188, 240, 60]  # three reach the window, the last stays young
NO_PROMPT = (np.zeros(0, np.int32), np.zeros((0, 80), np.float32))


@pytest.fixture(scope="module")
def pair():
    t = jnp.zeros((1, 8), jnp.int32)
    llm = np_params(jllm.CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t, gain=2.0)
    flow = np_params(CausalMaskedDiffWithDiT(JC.flow), 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                     jnp.asarray([16]), jnp.zeros((1, 192)), jax.random.PRNGKey(0))
    hift = np_params(CausalHiFT(JC.hift), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    hift["f0_predictor"]["classifier"]["bias"] = np.asarray([150.0], np.float32)  # voiced frames
    jtts = JaxTTS(JC, to_jax(llm), to_jax(flow), to_jax(hift), dtype=jnp.float32)
    ttts = TorchTTS(TC, llm_from_jax(llm, TC.llm), flow_from_jax(flow, TC.flow), hift_from_jax(hift, TC.hift),
                    dtype=torch.float32, device="cpu")
    for tts in (jtts, ttts):
        tts.stream_window_tokens = WINDOW
    return jtts, ttts, hift


def _sessions():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 50, n).astype(np.int32), rng.standard_normal(192).astype(np.float32)) for n in LENGTHS]


def _vc(tts, toks, emb) -> list:
    return [np.asarray(c["tts_speech"]) for c in tts.tts(source_speech_token=toks, flow_embedding=emb,
                                                        prompt_speech_feat=NO_PROMPT[1], stream=True)]


@pytest.fixture(scope="module")
def refs(pair):
    """Each session's solo stream: the JAX package's, and the port's with
    the full-prefix young hops."""
    jtts, ttts, _ = pair
    jax_chunks = [_vc(jtts, *s) for s in _sessions()]
    ttts.flow_kv_stream = False
    try:
        solo = [_vc(ttts, *s) for s in _sessions()]
    finally:
        ttts.flow_kv_stream = True
    return jax_chunks, solo


def _held(got: np.ndarray, jax_ref: list, solo: list, label: str) -> None:
    j, s = np.concatenate(jax_ref), np.concatenate(solo)
    assert got.shape == j.shape == s.shape, f"{label}: {got.shape} vs {j.shape}"
    np.testing.assert_allclose(got, j, rtol=0, atol=JAX_ATOL, err_msg=label)
    np.testing.assert_allclose(got, s, rtol=0, atol=SOLO_ATOL, err_msg=label)
    assert np.abs(j).max() > 1e-2


def test_padded_streaming_prepare(pair):
    """Right-padded rows [prompt ++ tokens ++ lookahead ++ zeros] of three
    lengths: the JAX package's mu and mel_len, and each row's valid frames
    equal to the exact-length context-split call on that row alone."""
    jtts, ttts, _ = pair
    rng = np.random.default_rng(3)
    lens = [12, 31, 20]
    tok = np.zeros((3, 40), np.int32)
    for i, n in enumerate(lens):
        tok[i, :n] = rng.integers(0, 50, n)
    pf = (rng.standard_normal((3, 8, 80)) * 0.5).astype(np.float32)
    emb = rng.standard_normal((3, 192)).astype(np.float32)
    args = (tok, np.asarray(lens, np.int32), pf, np.full(3, 8, np.int32), emb)
    jout = jtts.flow.apply({"params": jtts.flow_params}, *map(jnp.asarray, args), finalize=False,
                           padded_streaming=True, method=CausalMaskedDiffWithDiT.prepare_inference)
    with torch.no_grad():
        tout = ttts.flow.prepare_inference(*map(torch.from_numpy, args), finalize=False, padded_streaming=True)
    for j, t in zip(jout[:3], tout[:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(tout[3].numpy(), (np.asarray(lens) - 3) * 2)
    for i, n in enumerate(lens):
        with torch.no_grad():
            mu1 = ttts.flow.prepare_inference(torch.from_numpy(tok[i : i + 1, :n]), torch.tensor([n]),
                                              torch.from_numpy(pf[i : i + 1]), torch.tensor([8]),
                                              torch.from_numpy(emb[i : i + 1]), finalize=False)[0]
        np.testing.assert_allclose(tout[0][i, : (n - 3) * 2].numpy(), mu1[0].numpy(), rtol=0, atol=1e-6)


def test_per_row_hift_windows(pair):
    """B = 3 windows at three noise offsets (one past the buffer's wrap),
    carries and valid lengths."""
    _, ttts, hp = pair
    jm, jp, tm = jhift.CausalHiFT(JC.hift), to_jax(hp), ttts.hift
    rng = np.random.default_rng(5)
    mel = (rng.standard_normal((3, 108, 80)) * 0.5).astype(np.float32)
    carry = rng.random((3, 9)).astype(np.float32)
    buf = thift.nsf_buffers(9)[1][:, : 24000 * 10]
    offs = np.asarray([0, 7 * 480, 24000 * 10 - 100], np.int32)
    n_valid = np.asarray([40, 108, 75], np.int32)
    t = torch.from_numpy
    with torch.no_grad():
        sw = tm.stream_window(t(mel), t(carry), t(offs), t(buf)).numpy()
        fw = tm.finalize_window(t(mel), t(n_valid), t(carry), t(offs), t(buf)).numpy()
        rd = tm.rad_delta(t(mel[:, :61]), 8).numpy()
        for i in range(3):
            one = slice(i, i + 1)
            np.testing.assert_allclose(sw[one], tm.stream_window(t(mel[one]), t(carry[one]), int(offs[i]),
                                                                 t(buf)).numpy(), rtol=0, atol=SOLO_ATOL)
            np.testing.assert_allclose(fw[one, : n_valid[i] * 480],
                                       tm.finalize_window(t(mel[one]), int(n_valid[i]), t(carry[one]), int(offs[i]),
                                                          t(buf)).numpy()[:, : n_valid[i] * 480],
                                       rtol=0, atol=SOLO_ATOL)
            np.testing.assert_allclose(rd[one], tm.rad_delta(t(mel[one, :61]), 8).numpy(), rtol=0, atol=SOLO_ATOL)
    j = lambda method, *a, **k: np.asarray(jax.jit(lambda *x: jm.apply({"params": jp}, *x, method=method, **k))(
        *map(jnp.asarray, a)))
    np.testing.assert_allclose(sw, j(CausalHiFT.stream_window, mel, carry, offs, buf), rtol=0, atol=JAX_ATOL)
    jfw = j(CausalHiFT.finalize_window, mel, n_valid[:, None, None], carry, offs, buf)
    for i in range(3):
        np.testing.assert_allclose(fw[i, : n_valid[i] * 480], jfw[i, : n_valid[i] * 480], rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(rd, j(CausalHiFT.rad_delta, mel[:, :61], n_left=8), rtol=0, atol=1e-4)
    assert np.abs(sw).max() > 1e-2


def _group_run(ttts, finish_many: bool) -> list:
    """The four sessions through one group, fed 64 tokens at a time in
    lockstep; each slot's chunks."""
    sess = _sessions()
    g = BatchedStreamGroup(ttts, [(*NO_PROMPT, emb) for _, emb in sess])
    got, pos = [[] for _ in sess], [0] * len(sess)
    while True:
        fed = False
        for i, (toks, _) in enumerate(sess):
            if pos[i] < len(toks):
                g.feed(i, toks[pos[i] : pos[i] + 64])
                pos[i] += 64
                fed = True
        chunks = g.step()
        for slot, audio in chunks:
            got[slot].append(audio)
        if not fed and not chunks:
            break
    tails = g.finish_many(list(range(len(sess)))) if finish_many else {i: g.finish(i) for i in range(len(sess))}
    for i in range(len(sess)):
        got[i].append(tails[i])
    return got


@pytest.fixture(scope="module")
def lockstep(pair):
    return _group_run(pair[1], finish_many=False)


def test_group_lockstep(refs, lockstep):
    """Window hops, bucketed young hops and steady vocoder pushes batched,
    sequential finish: each slot's chunks have the solo chunks' lengths."""
    jax_chunks, solo = refs
    got = lockstep
    for i in range(len(LENGTHS)):
        assert [len(c) for c in got[i]] == [len(c) for c in jax_chunks[i]] == [len(c) for c in solo[i]]
        _held(np.concatenate(got[i]), jax_chunks[i], solo[i], f"slot {i}")


def test_finish_many_equals_sequential_finish(pair, refs, lockstep):
    """The cohort finalize (three steady slots in one flow and one vocoder
    call, the young slot through finish()) against sequential finish()."""
    jax_chunks, solo = refs
    seq, bat = lockstep, _group_run(pair[1], finish_many=True)
    for i in range(len(LENGTHS)):
        assert [len(c) for c in bat[i]] == [len(c) for c in seq[i]]
        np.testing.assert_allclose(np.concatenate(bat[i]), np.concatenate(seq[i]), rtol=0, atol=SOLO_ATOL)
        _held(np.concatenate(bat[i]), jax_chunks[i], solo[i], f"slot {i}")
    np.testing.assert_array_equal(bat[3][-1], seq[3][-1])  # the young slot: the same finish()


def test_scheduler_async_clients(pair, refs):
    """Four client threads feeding 40 tokens at jittered times through one
    width-4 scheduler: each stream holds, and the steps batch."""
    _, ttts, _ = pair
    jax_chunks, solo = refs
    sess = _sessions()
    sched = StreamScheduler(ttts, width=4, window_s=0.25)
    rng = np.random.default_rng(21)
    jitters = [rng.random(16) * 0.01 for _ in sess]
    got, errs = [None] * len(sess), []

    def client(i):
        try:
            toks, emb = sess[i]
            h = sched.open(*NO_PROMPT, emb)
            chunks = []
            for j, p in enumerate(range(0, len(toks), 40)):
                time.sleep(jitters[i][j])
                chunks += sched.feed(h, toks[p : p + 40])
            got[i] = np.concatenate(chunks + [sched.close(h)])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(len(sess))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errs, errs
    assert not any(t.is_alive() for t in ts)
    for i in range(len(sess)):
        _held(got[i], jax_chunks[i], solo[i], f"client {i}")
    assert sched.stats["rows"] / sched.stats["steps"] > 1.5, sched.stats


def test_scheduler_churn(pair, refs):
    """Opens, feeds and closes in a random order on a width-2 scheduler:
    groups fill, slots recycle, every session holds."""
    _, ttts, _ = pair
    jax_chunks, solo = refs
    sess = _sessions()
    sched = StreamScheduler(ttts, width=2, prewarm=False)
    rng = np.random.default_rng(11)
    order = [0, 3, 1, 2, 3]  # the last on a recycled slot
    live, done = {}, []
    while order or live:
        if order and (len(live) < 3 and rng.random() < 0.5 or not live):
            i = order.pop(0)
            live[sched.open(*NO_PROMPT, sess[i][1])] = [i, 0, []]
            continue
        h = list(live)[int(rng.integers(len(live)))]
        i, pos, chunks = live[h]
        if pos < len(sess[i][0]):
            chunks += sched.feed(h, sess[i][0][pos : pos + 50])
            live[h][1] = pos + 50
        else:
            done.append((i, np.concatenate(chunks + [sched.close(h)])))
            del live[h]
    assert len(done) == 5 and len(sched.groups[0]) >= 2
    for i, audio in done:
        _held(audio, jax_chunks[i], solo[i], f"session {i}")


def test_close_error_reaches_cohort(pair, monkeypatch):
    """An exception in a cohort's finalize reaches each of its closers, and
    the group takes no new session."""
    _, ttts, _ = pair
    sess = _sessions()
    sched = StreamScheduler(ttts, width=2, window_s=0.5, prewarm=False)
    hs = [sched.open(*NO_PROMPT, sess[i][1]) for i in range(2)]
    g = sched.groups[0][0]
    monkeypatch.setattr(g, "finish_many", lambda slots: (_ for _ in ()).throw(RuntimeError("finalize failed")))
    errs = []

    def closer(h):
        try:
            sched.close(h)
        except RuntimeError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=closer, args=(h,)) for h in hs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert errs == ["finalize failed"] * 2 and not sched.sessions and not g.owners


def test_tts_stream_both_schedulers(pair):
    """tts(stream=True) with enable_batched_llm and enable_batched_streaming:
    two concurrent greedy text requests decode in one continuous batch and
    stream through one group; tokens, so audio, as the solo streams."""
    _, ttts, _ = pair
    rng = np.random.default_rng(1)
    reqs = [dict(text=rng.integers(0, 300, 3).astype(np.int32), flow_embedding=rng.standard_normal(192).astype(np.float32),
                 min_token_text_ratio=30, max_token_text_ratio=30) for _ in range(2)]
    ttts.flow_kv_stream = False
    try:
        want = [np.concatenate([c["tts_speech"] for c in ttts.tts(stream=True, **r)]) for r in reqs]
        ttts.enable_batched_llm(2)
        ttts.enable_batched_streaming(2)
        got = [None, None]

        def run(i):
            got[i] = np.concatenate([c["tts_speech"] for c in ttts.tts(stream=True, **reqs[i])])

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        stats = ttts.llm_scheduler.stats, ttts.stream_scheduler.stats
    finally:
        ttts.flow_kv_stream = True
        ttts.llm_scheduler = ttts.stream_scheduler = None
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape and len(w) == 90 * 2 * 480
        np.testing.assert_allclose(g, w, rtol=0, atol=SOLO_ATOL)
    assert stats[0]["steps"] > 0 and stats[1]["steps"] > 0
