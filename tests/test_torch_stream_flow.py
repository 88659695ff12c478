"""The streaming flow of fangyan_tts_torch against the JAX package, float32
on the CPU, with the same weights (models/from_jax.flow_from_jax) and a DiT
whose static chunk is the streaming hop (50 mel frames, 25 tokens): the
KV-cached estimator `DiTChunk` and one Euler hop `cfm_solve_chunk` agree
with the JAX package's within 1e-3 and with the port's own full-prefix
chunk-masked solve (`DiT` / `cfm_solve(streaming=True)`); and
`infer/stream.FlowStream` gives the JAX package's mel hop by hop and at
finalize (within 1e-3), with the KV-cached young phase and without it,
across the window boundary (`stream_window_tokens` 100), without a prompt
and with one whose length is no multiple of the hop (prompt_pad 18)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.infer.stream import FlowStream as TorchFlowStream
from fangyan_tts_torch.infer.tts import CosyVoice3TTS as TorchTTS
from fangyan_tts_torch.models import flow as tflow
from fangyan_tts_torch.models.dit import DiTChunk, precompute_mods
from fangyan_tts_torch.models.from_jax import flow_from_jax, hift_from_jax, llm_from_jax
from fangyan_tts_torch.ops.masks import chunk_split_bias as t_split_bias
from fangyan_tts_tpu.infer.stream import FlowStream as JaxFlowStream
from fangyan_tts_tpu.infer.tts import CosyVoice3TTS as JaxTTS
from fangyan_tts_tpu.models import dit as jdit
from fangyan_tts_tpu.models import flow as jflow
from fangyan_tts_tpu.models.hift import CausalHiFT
from fangyan_tts_tpu.models.llm import CosyVoice3LM
from fangyan_tts_tpu.ops.masks import chunk_split_bias as j_split_bias
from torch_port_util import both, np_params, to_jax

JC, TC = (replace(c, flow=replace(c.flow, dit=replace(c.flow.dit, static_chunk_size=50)),
                  hift=replace(c.hift, stream_noise_seconds=10)) for c in both())
CH = 50


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def flows():
    jm = jflow.CausalMaskedDiffWithDiT(JC.flow)
    t = jnp.zeros((1, 8), jnp.int32)
    p = np_params(jm, 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)), jnp.asarray([16]), jnp.zeros((1, 192)),
                  jax.random.PRNGKey(0))
    tm = tflow.CausalMaskedDiffWithDiT(TC.flow)
    tm.load_state_dict(flow_from_jax(p, TC.flow), strict=True)
    return jm, p, tm.eval()


def test_dit_chunk(flows):
    """Three hops of 50 frames (B = 2) through DiTChunk with the caches
    appended between them: each hop within 1e-3 of the JAX DiTChunk on the
    same caches, and the whole within 1e-4 of one chunk-masked DiT call."""
    _, p, tm = flows
    c = JC.flow.dit
    rng = np.random.default_rng(0)
    b, l = 2, 150
    x, mu, cond = (rng.standard_normal((b, l, 80)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((b, 80)).astype(np.float32)
    t = np.asarray([0.3, 0.3], np.float32)
    dc = DiTChunk.of(tm.estimator)
    assert dc.blocks[0].attn.to_qkv.weight.data_ptr() == tm.estimator.blocks[0].attn.to_qkv.weight.data_ptr()
    cap, pad = 192, c.conv_pos_kernel - 1
    cache = {"k": np.zeros((c.depth, b, c.heads, cap, c.dim_head), np.float32), "tail1": np.zeros((b, pad, c.dim), np.float32)}
    cache["v"], cache["tail2"] = cache["k"].copy(), cache["tail1"].copy()
    with torch.no_grad():
        mods = precompute_mods(dc, _t(t)[None], torch.float32)[0]
        full = tm.estimator(*(_t(a) for a in (x, mu, t, spks, cond)), _t(np.asarray([l, l], np.int32)), CH, mods)
    outs = []
    for s in range(0, l, CH):
        lens, q_valid = np.full(b, s, np.int32), np.full(b, CH, np.int32)
        bc, bn = j_split_bias(jnp.asarray(lens), jnp.asarray(q_valid), CH, cap, CH)
        args = [a[:, s : s + CH] for a in (x, mu)] + [t, spks, cond[:, s : s + CH]]
        want, _ = jdit.DiTChunk(c).apply({"params": to_jax(p["estimator"])}, *(jnp.asarray(a) for a in args),
                                         jax.tree.map(jnp.asarray, cache), jnp.asarray(lens), bc, bn)
        tbc, tbn = t_split_bias(_t(lens), _t(q_valid), CH, cap, CH)
        with torch.no_grad():
            got, new = dc(*(_t(a) for a in args), {k: _t(v) for k, v in cache.items()}, _t(lens), tbc, tbn, mods)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
        outs.append(got)
        cache["k"][:, :, :, s : s + CH] = new["k"].numpy()
        cache["v"][:, :, :, s : s + CH] = new["v"].numpy()
        cache["tail1"], cache["tail2"] = new["tail1"].numpy(), new["tail2"].numpy()
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), rtol=0, atol=1e-4)


def test_cfm_solve_chunk(flows):
    """A prompted stream (7 prompt tokens, prompt_pad 18): the KV prefill,
    two hops and a 4-token finalize hop through cfm_solve_chunk, each within
    1e-3 of the JAX package's cfm_solve_chunk on the same inputs, and the
    emitted frames within 2e-4 of the full-prefix streaming solve."""
    jm, p, tm = flows
    jp, cfg, tcfg = to_jax(p), JC.flow, TC.flow
    rng = np.random.default_rng(1)
    P, hop, ratio, la = 7, 25, 2, 3
    pad, P_mel = (-P) % hop, P * ratio
    n_target = pad + 3 * hop + 4
    toks = rng.integers(0, 50, P + n_target + la).astype(np.int32)
    prompt, target = toks[:P], toks[P:]
    pf = (rng.standard_normal((1, P_mel, 80)) * 0.5).astype(np.float32)
    emb = rng.standard_normal((1, 192)).astype(np.float32)
    noise = rng.standard_normal((1, 600, 80)).astype(np.float32)

    def prep(n_cons, finalize=False):
        tok = np.concatenate([prompt, target[: n_cons + (0 if finalize else la)]])[None]
        with torch.no_grad():
            return tm.prepare_inference(_t(tok), _t([tok.shape[1]]), _t(pf), _t([P_mel]), _t(emb), finalize=finalize)

    def full(n_cons, finalize=False):
        mu, spks, conds, mel_len = prep(n_cons, finalize)
        return tflow.cfm_solve(tcfg, tm.estimator, _t(noise[:, : mu.shape[1]]), mu, spks, conds, mel_len, streaming=True)

    cap = 256
    jcache = jflow.empty_kv_cache(cfg, 2, cap, jnp.float32)
    tcache = tflow.empty_kv_cache(tcfg, 2, cap, torch.float32)
    dc = tm.estimator_chunk

    def hop_both(z, mu, spks, conds, lens, q_valid):
        nonlocal jcache
        want, jcache = jflow.cfm_solve_chunk(cfg, jp["estimator"], *(jnp.asarray(a.numpy()) for a in (z, mu, spks, conds)),
                                             jcache, jnp.asarray([lens], jnp.int32), jnp.asarray([q_valid], jnp.int32))
        got = tflow.cfm_solve_chunk(tcfg, dc, z, mu, spks, conds, tcache, [lens], [q_valid])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
        return got

    n0 = hop + pad
    mu0, spks0, conds0, _ = prep(n0)
    lq0 = P_mel + n0 * ratio
    outs = [hop_both(_t(noise[:, :lq0]), mu0[:, :lq0], spks0, conds0[:, :lq0], 0, lq0)[:, P_mel:]]
    lens = lq0
    for k in (2, 3):
        s = hop * (k - 1) + pad
        with torch.no_grad():
            mu = tm.prepare_chunk(_t(target[s - 2 : s + hop + la][None]))
        outs.append(hop_both(_t(noise[:, lens : lens + CH]), mu, spks0, torch.zeros((1, CH, 80)), lens, CH))
        lens += CH
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full(pad + 3 * hop)[:, P_mel:].numpy(), rtol=0,
                               atol=2e-4)
    s, n_rem = pad + 3 * hop, 4
    with torch.no_grad():
        mu = tm.prepare_chunk(_t(target[s - 2 : s + n_rem][None]), finalize=True)
    got = hop_both(_t(noise[:, lens : lens + n_rem * ratio]), mu, spks0, torch.zeros((1, n_rem * ratio, 80)), lens,
                   n_rem * ratio)
    np.testing.assert_allclose(got.numpy(), full(n_target, True)[:, lens : lens + n_rem * ratio].numpy(), rtol=0,
                               atol=2e-4)


def _pair(p_flow):
    t = jnp.zeros((1, 8), jnp.int32)
    llm = np_params(CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t)
    hift = np_params(CausalHiFT(JC.hift), 2, jnp.zeros((1, 16, 80)), gain=0.5)
    jtts = JaxTTS(JC, to_jax(llm), to_jax(p_flow), to_jax(hift), dtype=jnp.float32)
    ttts = TorchTTS(TC, llm_from_jax(llm, TC.llm), flow_from_jax(p_flow, TC.flow), hift_from_jax(hift, TC.hift),
                    dtype=torch.float32, device="cpu")
    for tts in (jtts, ttts):
        tts.stream_window_tokens = 100
    return jtts, ttts


@pytest.fixture(scope="module")
def pair(flows):
    return _pair(flows[1])


@pytest.mark.parametrize("n_prompt, kv, n_tokens", [
    (0, True, 160),  # three KV hops (the cache grows 128 -> 256), then window hops and a window finalize
    (7, True, 160),  # prompt_pad 18: frames held back a hop
    (7, False, 160),  # the full-prefix young phase
    (0, True, 92),  # under the window: the KV finalize
    (7, False, 80),  # under the window: the full-prefix finalize
])
def test_flow_stream(pair, n_prompt, kv, n_tokens):
    jtts, ttts = pair
    rng = np.random.default_rng(n_prompt + n_tokens)
    ptok = rng.integers(0, 50, n_prompt).astype(np.int32)
    pf = (rng.standard_normal((2 * n_prompt, 80)) * 0.5).astype(np.float32)
    emb = rng.standard_normal(192).astype(np.float32)
    tokens = rng.integers(0, 50, n_tokens).astype(np.int32)
    pad = -n_prompt % 25
    for tts in (jtts, ttts):
        tts.flow_kv_stream = kv
    jfs, tfs = JaxFlowStream(jtts, ptok, pf, emb, pad), TorchFlowStream(ttts, ptok, pf, emb, pad)
    hops = 0
    while 25 * (hops + 1) + pad + 3 <= n_tokens:
        want, got = np.asarray(jfs.step(tokens)), tfs.step(tokens).numpy()
        assert got.shape == want.shape == (1, 50, 80)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=f"hop {hops + 1}")
        hops += 1
    assert hops >= 2
    (want, n_want), (got, n_got) = jfs.finalize(tokens), tfs.finalize(tokens)
    assert n_got == n_want > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    if kv and n_tokens < 100:
        assert tfs._kv_cap == 256  # the ladder grew once
