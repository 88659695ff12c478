"""fangyan_tts_torch's MLA-MoE speech LM (models/mla_moe.py, ops/moe.py,
ops/mla_decode.py) against the benchmark's plain float32 reference,
benchmark/reference/moonlight_lm.py, at a small size on the CPU: hidden 64, 4
layers (1 dense + 3 MoE), 8 experts, 2 a token, one shared expert, a
nonzero correction bias. Float32 throughout: logits rel <= 2e-4 with equal
argmax (the PARITY thresholds). Also the refusals of the paths that keep
Qwen2's cache, the converter from the published checkpoint's names, and
the MoE counters and spans the tracer records."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference.moonlight_lm import SpeechLM
from fangyan_tts_torch.config import CosyVoiceConfig, DiTConfig, FlowConfig, HiFTConfig, LLMConfig, MLAMoEConfig
from fangyan_tts_torch.models import llm as tllm
from fangyan_tts_torch.models import mla_moe
from fangyan_tts_torch.ops import mla_decode as mla_ops
from fangyan_tts_torch.ops import moe as moe_ops

torch.set_num_threads(1)

MLA = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=4, first_k_dense_replace=1,
           num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, routed_scaling_factor=2.446,
           norm_topk_prob=True, rms_norm_eps=1e-5, rope_theta=50000.0, vocab_size=300)
LLM = dict(llm_input_size=64, llm_output_size=64, speech_token_size=50, extra_tokens=8, top_k=1, tau_r=1.1)
REF = dict(MLA, **LLM)
RTOL = 2e-4


def _cfg() -> LLMConfig:
    return LLMConfig(**LLM, qwen=MLAMoEConfig(**MLA))


def _state(seed: int = 0, gain: float = 1.0) -> dict:
    """The reference's parameters from numpy: N(0, gain^2 / fan_in) matrices,
    N(0, 1) tables, 1 + N(0, 0.01) norms, N(0, 0.1) correction biases."""
    with torch.device("meta"):
        names = SpeechLM(REF).state_dict()
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in names.items():
        shape = tuple(v.shape)
        if k.endswith("e_score_correction_bias"):
            a = rng.normal(0.0, 0.1, shape)
        elif k.endswith("norm.weight") or "layernorm" in k:
            a = 1.0 + rng.normal(0.0, 0.01, shape)
        elif "embed" in k:
            a = rng.normal(0.0, 1.0, shape)
        else:
            a = rng.normal(0.0, gain / np.sqrt(shape[-1]), shape)
        out[k] = torch.tensor(a, dtype=torch.float32)
    return out


def _models(seed: int = 0):
    sd = _state(seed)
    ref = SpeechLM(REF)
    ref.load_state_dict(sd, strict=True)
    port = tllm.CosyVoice3LM(_cfg(), dtype=torch.float32)
    port.load_state_dict(sd, strict=True)
    return ref.eval(), port.eval()


def _rel(got, want) -> float:
    return float((got.detach() - want.detach()).norm() / want.detach().norm())


def test_moe_layer_matches_reference():
    ref, port = _models()
    x = torch.tensor(np.random.default_rng(3).normal(size=(2, 9, 64)), dtype=torch.float32)
    with torch.no_grad():
        want = ref.llm.layers[1].mlp(x.reshape(18, 64))
        got = port.llm.layers[1].mlp(x)
    assert _rel(got.reshape(18, 64), want) <= RTOL
    chosen, _ = port.llm.layers[1].mlp.route(x.reshape(18, 64))
    bias_off = torch.topk(torch.sigmoid(x.reshape(18, 64) @ port.llm.layers[1].mlp.gate.weight.T), 2).indices
    assert not torch.equal(chosen.sort(1).values, bias_off.sort(1).values)  # the bias moves the selection


def _plan(rows, tp):
    """Left-padded inference prompts (src, ids, lengths) of (text, prompt speech) lengths `rows`."""
    rng = np.random.default_rng(5)
    ref = SpeechLM.__new__(SpeechLM)
    ref.c = REF
    plans = [ref.plan(rng.integers(0, 300, n), rng.integers(0, 50, m)) for n, m in rows]
    src = np.zeros((len(rows), tp), np.int64)
    ids = np.zeros((len(rows), tp), np.int64)
    for r, (s, i) in enumerate(plans):
        src[r, tp - len(s):], ids[r, tp - len(i):] = s, i
    return plans, torch.tensor(src), torch.tensor(ids), torch.tensor([len(s) for s, _ in plans], dtype=torch.int32)


@pytest.mark.parametrize("rows", [((9, 4), (5, 2)), ((3, 0),)])
def test_prefill_and_decode_through_latent_cache(rows):
    """Left-padded prefill into a float32 latent cache, then teacher-forced
    decode steps through the absorbed decode (ops/mla_decode's plain
    version): every step's logits against the reference's full forward."""
    ref, port = _models()
    tp, steps = 16, 6
    plans, src, ids, lens = _plan(rows, tp)
    b = len(rows)
    cache = port.llm.init_cache(b, 32, dtype=torch.float32)
    forced = torch.tensor(np.random.default_rng(9).integers(0, 50, (b, steps)), dtype=torch.int64)
    with torch.no_grad():
        got = [port.decode_logits(port.prefill_leftpad(src, ids, lens, cache))]
        start = (tp - lens).to(torch.int32)
        for i in range(steps):
            got.append(port.decode_step(forced[:, i], (lens + i)[:, None].to(torch.int32), start, tp + i + 1, cache))
    assert int(cache["index"][0]) == tp + steps
    for r, (s, i) in enumerate(plans):
        seq_src = torch.tensor(s + [1] * steps)
        seq_ids = torch.tensor(i + forced[r].tolist())
        with torch.no_grad():
            want = ref.logits(seq_src, seq_ids)[len(s) - 1:]
        for k in range(steps + 1):
            assert _rel(got[k][r], want[k]) <= RTOL, (r, k)
            assert int(got[k][r].argmax()) == int(want[k].argmax())


def test_cache_free_forward_matches_reference_and_trains():
    """The training forward (cache=None) on right-padded plans: its logits
    against the reference's, and its loss backpropagates."""
    ref, port = _models()
    plans, _, _, _ = _plan(((7, 3), (4, 1)), 16)
    t = max(len(s) for s, _ in plans)
    src = torch.tensor([s + [1] * (t - len(s)) for s, _ in plans])
    ids = torch.tensor([i + [0] * (t - len(i)) for _, i in plans])
    lens = torch.tensor([len(s) for s, _ in plans], dtype=torch.int32)
    x = port.embed_plan(src, ids)
    pos = torch.arange(t, dtype=torch.int32).expand(2, t)
    from fangyan_tts_torch.models.qwen2 import prefill_attn_bias

    got = port.decode_logits(port.llm(x, pos, prefill_attn_bias(t, lens)))
    for r, (s, i) in enumerate(plans):
        with torch.no_grad():
            want = ref.logits(torch.tensor(s), torch.tensor(i))
        assert _rel(got[r, : len(s)].detach(), want) <= RTOL
    targets = torch.where(torch.arange(t)[None, :] < lens[:, None], torch.arange(t)[None, :] % 50, -1)
    loss, _ = port(src, ids, lens, targets)
    loss.backward()
    assert torch.isfinite(loss) and port.llm.layers[2].mlp.experts.gate_up.grad.abs().sum() > 0


def _expert_inputs(n=13, k=2, e=8, d=64, width=32, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    chosen = torch.tensor(np.stack([rng.choice(e, k, replace=False) for _ in range(n)]), dtype=torch.int64)
    w = torch.tensor(rng.uniform(0.1, 1.0, (n, k)), dtype=torch.float32)
    gate_up = torch.tensor(rng.normal(size=(e, 2 * width, d)) / np.sqrt(d), dtype=torch.float32)
    down = torch.tensor(rng.normal(size=(e, d, width)) / np.sqrt(width), dtype=torch.float32)
    return x, chosen, w, gate_up, down


def test_moe_experts_plain_matches_reference():
    """ops/moe's plain version (the CPU route) against the reference's
    per-expert sum, and its counters."""
    x, chosen, w, gate_up, down = _expert_inputs()
    stats = torch.zeros(3, dtype=torch.int64)
    got = moe_ops.moe_experts(x, chosen, w, gate_up, down, stats)
    want = torch.zeros_like(x)
    for r in range(x.shape[0]):
        for j in range(chosen.shape[1]):
            e = int(chosen[r, j])
            g, u = (x[r] @ gate_up[e].T).chunk(2)
            want[r] += w[r, j] * ((torch.nn.functional.silu(g) * u) @ down[e].T)
    assert _rel(got, want) <= RTOL
    assert stats.tolist() == [1, len(set(chosen.flatten().tolist())), chosen.numel()]


@pytest.mark.parametrize("e", [8, 64])
def test_route_order_sorts_by_expert(e):
    """The device-side routing: items sorted by expert, stable, with each
    expert's offsets, empty experts included."""
    rng = np.random.default_rng(e)
    chosen = torch.tensor(rng.integers(0, e // 2, (17, 3)), dtype=torch.int64)
    order, offsets, counts = moe_ops.route_order(chosen, e)
    flat = chosen.reshape(-1)
    assert torch.equal(order.long(), torch.sort(flat, stable=True).indices)
    assert offsets[0] == 0 and offsets[-1] == flat.numel() and torch.equal(offsets.diff(), counts.to(torch.int32))
    assert all(int(counts[k]) == 0 for k in range(e // 2, e))


def test_mla_decode_plain_is_decompressed_attention():
    """The absorbed decode (ops/mla_decode's plain version) against
    attention over the decompressed keys and values, with the row write."""
    ref, port = _models()
    attn = port.llm.layers[0].self_attn
    rng = np.random.default_rng(2)
    b, s, nh, dn, dr, dv, r = 2, 24, 4, 16, 8, 16, 32
    cache = torch.tensor(rng.normal(size=(1, b, s, r + dr)), dtype=torch.float32)
    q_nope = torch.tensor(rng.normal(size=(b, nh, dn)), dtype=torch.float32)
    q_pe = torch.tensor(rng.normal(size=(b, nh, dr)), dtype=torch.float32)
    new = torch.tensor(rng.normal(size=(b, r + dr)), dtype=torch.float32)
    idx = torch.tensor([20, 20], dtype=torch.int32)
    bias = torch.where(torch.arange(s)[None, :] < torch.tensor([[21], [21]]), 0.0, -1e10)
    bias[1, :5] = -1e10
    w = attn.kv_b_proj.weight.reshape(nh, dn + dv, r)
    q_full = torch.cat([torch.einsum("bhd,hdr->bhr", q_nope, w[:, :dn]), q_pe], -1)
    scale = 1 / np.sqrt(dn + dr)
    want_cache = cache.clone()
    want_cache[0, :, 20] = new
    got = mla_ops.mla_decode(q_full, new, cache, idx, bias.float(), 0, scale, r)
    assert torch.equal(cache, want_cache)
    lat, kpe = want_cache[0].split([r, dr], -1)
    k_nope, v = (lat @ attn.kv_b_proj.weight.T).reshape(b, s, nh, dn + dv).split([dn, dv], -1)
    k = torch.cat([k_nope, kpe[:, :, None].expand(b, s, nh, dr)], -1)
    p = torch.softmax(torch.einsum("bhd,bshd->bhs", torch.cat([q_nope, q_pe], -1), k) * scale + bias[:, None], -1)
    want = torch.einsum("bhs,bshd->bhd", p, v)
    assert _rel(torch.einsum("bhr,hvr->bhv", got, w[:, dn:]), want) <= RTOL


def _tts(seed: int = 0):
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS, _random_state
    from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT
    from fangyan_tts_torch.models.hift import CausalHiFT

    cfg = CosyVoiceConfig(llm=_cfg(), flow=FlowConfig(input_size=80, vocab_size=50, n_timesteps=2,
                                                      pre_lookahead_channels=32,
                                                      dit=DiTConfig(dim=32, depth=1, heads=2, dim_head=16,
                                                                    static_chunk_size=10)),
                          hift=HiFTConfig(base_channels=32, f0_cond_channels=16))
    gen = torch.Generator().manual_seed(seed)
    flow = _random_state(lambda: CausalMaskedDiffWithDiT(cfg.flow), torch.float32, gen, torch.device("cpu"))
    hift = _random_state(lambda: CausalHiFT(cfg.hift), torch.float32, gen, torch.device("cpu"))
    return CosyVoice3TTS(cfg, _state(seed), flow, hift, dtype=torch.float32, device="cpu")


def _request():
    rng = np.random.default_rng(4)
    return dict(prompt_text=rng.integers(0, 300, 3).astype(np.int32),
                flow_prompt_speech_token=rng.integers(0, 50, 5).astype(np.int32),
                prompt_speech_feat=(rng.standard_normal((10, 80)) * 0.5).astype(np.float32),
                flow_embedding=rng.standard_normal(192).astype(np.float32),
                min_token_text_ratio=3, max_token_text_ratio=3)


def test_batch_synthesize_greedy_tokens_are_reference_argmax(monkeypatch):
    """batch_synthesize through generate_speech_tokens (greedy) with a
    float32 decode cache: every served token is the reference's argmax
    over the speech ids, teacher-forced on the tokens before it; the MoE
    counters and spans come out as the loop implies."""
    from fangyan_tts_torch.utils import profiling

    monkeypatch.setattr(tllm, "CACHE_DTYPE", torch.float32)
    tts = _tts()
    ref = SpeechLM(REF)
    ref.load_state_dict(tts.llm.state_dict(), strict=True)
    rng = np.random.default_rng(6)
    texts = [rng.integers(0, 300, n).astype(np.int32) for n in (4, 7, 5)]
    seen = {}
    real = tts._batch_tokens

    def keep(*a, **k):
        seen["out"] = real(*a, **k)
        return seen["out"]

    tts._batch_tokens = keep
    profiling.reset()
    try:
        with profiling.recording():
            wavs = tts.batch_synthesize(texts, **_request())
        counters, names = profiling.counters(), [s["name"] for s in profiling.spans()]
    finally:
        profiling.reset()
    tokens, counts = seen["out"]
    assert [len(w) for w in wavs] == [3 * len(t) * 2 * 480 for t in texts]
    prompt_text = _request()["prompt_text"]
    for r, t in enumerate(texts):
        served = tokens[r, : counts[r]]
        assert len(served) == 3 * len(t)
        logits = ref.served_logits(np.concatenate([prompt_text, t]), np.zeros(0, np.int64), served)
        np.testing.assert_array_equal(logits[:, :50].argmax(-1).numpy(), served)
    steps = counters["llm.decode_steps"]
    assert steps == 3 * max(len(t) for t in texts)
    moe_layers = MLA["num_hidden_layers"] - MLA["first_k_dense_replace"]
    assert counters["moe.calls.decode"] == moe_layers * steps and counters["moe.calls.prefill"] == moe_layers
    assert counters["moe.routed_rows.decode"] == moe_layers * steps * len(texts) * 2
    assert 0 < counters["moe.active_experts.decode"] <= moe_layers * steps * MLA["n_routed_experts"]
    assert names.count("moe") == moe_layers * (steps + 1) and names.count("mla") == MLA["num_hidden_layers"] * (steps + 1)


def test_tts_offline_runs():
    tts = _tts()
    r = _request()
    wav = next(tts.tts(text=np.arange(4, dtype=np.int32), **r))["tts_speech"]
    assert wav.dtype == np.float32 and len(wav) == 12 * 2 * 480 and np.isfinite(wav).all()


def _refusals():
    def stream(tts):
        next(tts.tts(text=np.arange(4, dtype=np.int32), stream=True, **_request()))

    def bistream(tts):
        next(tts.tts(text=iter([np.arange(4, dtype=np.int32)]), **_request()))

    def shard(tts):
        from fangyan_tts_torch.parallel.mesh import Mesh
        from fangyan_tts_torch.parallel.sharding import shard_module

        shard_module(tts.llm, Mesh(tp=2))  # rank 0's view of a TP=2 mesh: refused before any collective

    return {"stream": stream, "bistream": bistream, "quantize_llm": lambda tts: tts.quantize_llm(),
            "batched_llm": lambda tts: tts.enable_batched_llm(2),
            "batched_streaming": lambda tts: tts.enable_batched_streaming(2), "tensor_parallel": shard}


@pytest.mark.parametrize("path", list(_refusals()))
def test_qwen2_only_paths_refuse(path):
    """The streaming decode, the bistream decode, the continuous batch and
    the stream scheduler, weight-only quantization and tensor parallelism
    raise NotImplementedError for the MLA-MoE backbone."""
    tts = _tts()
    with pytest.raises(NotImplementedError):
        _refusals()[path](tts)


def _hf_state(cfg: MLAMoEConfig, seed: int = 3) -> dict:
    """A tiny random state dict in the published checkpoint's names."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)
    d, nh = cfg.hidden_size, cfg.num_attention_heads
    sd = {"model.embed_tokens.weight": r(cfg.vocab_size, d), "model.norm.weight": r(d),
          "lm_head.weight": r(cfg.vocab_size, d)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": r(d), p + "post_attention_layernorm.weight": r(d),
                   p + "self_attn.q_proj.weight": r(nh * cfg.q_head_dim, d),
                   p + "self_attn.kv_a_proj_with_mqa.weight": r(cfg.latent_dim, d),
                   p + "self_attn.kv_a_layernorm.weight": r(cfg.kv_lora_rank),
                   p + "self_attn.kv_b_proj.weight": r(nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank),
                   p + "self_attn.o_proj.weight": r(d, nh * cfg.v_head_dim)})
        if i < cfg.first_k_dense_replace:
            w = cfg.intermediate_size
            sd.update({p + "mlp.gate_proj.weight": r(w, d), p + "mlp.up_proj.weight": r(w, d),
                       p + "mlp.down_proj.weight": r(d, w)})
            continue
        w, ws = cfg.moe_intermediate_size, cfg.moe_intermediate_size * cfg.n_shared_experts
        sd.update({p + "mlp.gate.weight": r(cfg.n_routed_experts, d),
                   p + "mlp.gate.e_score_correction_bias": r(cfg.n_routed_experts),
                   p + "mlp.shared_experts.gate_proj.weight": r(ws, d),
                   p + "mlp.shared_experts.up_proj.weight": r(ws, d),
                   p + "mlp.shared_experts.down_proj.weight": r(d, ws)})
        for e in range(cfg.n_routed_experts):
            sd.update({p + f"mlp.experts.{e}.gate_proj.weight": r(w, d), p + f"mlp.experts.{e}.up_proj.weight": r(w, d),
                       p + f"mlp.experts.{e}.down_proj.weight": r(d, w)})
    return sd


def test_converter_round_trip():
    """from_hf places every decoder tensor of the published names in the
    speech LM's (the text LM's head dropped), the LM loads them with only
    its own speech tables and head left, and to_hf gives them back."""
    cfg = _cfg()
    hf = _hf_state(cfg.qwen)
    got = mla_moe.from_hf(hf, cfg.qwen)
    port = tllm.CosyVoice3LM(cfg)
    missing, unexpected = port.load_state_dict(got, strict=False)
    assert sorted(missing) == ["llm_decoder.weight", "speech_embedding.weight"] and not unexpected
    back = mla_moe.to_hf(got, cfg.qwen)
    assert set(back) == set(hf) - {"lm_head.weight"}
    assert all(torch.equal(back[k], hf[k]) for k in back)
    gu = port.llm.layers[2].mlp.experts.gate_up[3]
    assert torch.equal(gu[: cfg.qwen.moe_intermediate_size], hf["model.layers.2.mlp.experts.3.gate_proj.weight"])
    with pytest.raises(ValueError):
        mla_moe.from_hf(dict(hf, **{"model.layers.9.input_layernorm.weight": torch.ones(64)}), cfg.qwen)


def test_config_round_trips_with_the_backbone():
    from fangyan_tts_torch.config import config_from_dict, config_to_json
    import json

    cfg = CosyVoiceConfig(llm=_cfg())
    back = config_from_dict(json.loads(config_to_json(cfg)))
    assert back == cfg and back.llm.backbone == "mla_moe" and LLMConfig().backbone == "qwen2"
