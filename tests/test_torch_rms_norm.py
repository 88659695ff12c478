"""The LM backbones' RMSNorm with the residual add before it
(fangyan_tts_torch/ops/rms_norm.py) on the CPU:

- `rms_norm_plain` is bit-equal to the former RMSNorm expressions, in
  bfloat16 and float32, with and without the residual, and on the MLA's
  strided split of kv_a_proj's output;
- a Qwen2 decode step (t = 1), a prefill and a training forward with grad
  (and remat), two MLAMoEBlocks in turn and a whole MLAMoEModel forward,
  each with every block's closing residual left to the next norm, are
  bit-equal to the former chain, written out below as the yardstick
  (outputs, caches and gradients);
- CPU calls count `llm.norms` and `llm.qkv` in the tracer and launch
  nothing; with the launches stubbed (the CPU has no Triton), inference
  takes both kernels for every call, on operands they can read, while the
  training forward with grad and a compiler's trace never reach them;
- the kernel route's refusals (grad, operands it cannot read);
- the benchmark's reader of the counters, `llm_fused_pct.datagen`.
"""

from types import SimpleNamespace

import pytest
import torch

from fangyan_tts_torch.config import MLAMoEConfig, QwenConfig
from fangyan_tts_torch.models import mla_moe
from fangyan_tts_torch.models import qwen2 as tq
from fangyan_tts_torch.ops import device
from fangyan_tts_torch.ops import qkv_rope as qr
from fangyan_tts_torch.ops import rms_norm as rn
from fangyan_tts_torch.ops.decode_attention import decode_attention
from fangyan_tts_torch.utils import profiling

QWEN = QwenConfig(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, vocab_size=128)
MLA = MLAMoEConfig(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
                   first_k_dense_replace=1, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
                   routed_scaling_factor=2.446, norm_topk_prob=True, rms_norm_eps=1e-5, rope_theta=50000.0,
                   vocab_size=300)
B, T, S = 2, 5, 12


# ---- the former chain, the yardstick ----------------------------------------------------------

def old_rms(norm, x):
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + norm.eps)
    return (x * norm.weight).to(dtype)


def old_rope(x, cos, sin):
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


def old_attention(att, x, cos, sin, attn_bias, layer, cache):
    c = att.cfg
    b, t, _ = x.shape
    hd, qh, kvh = c.head_dim, c.num_attention_heads, c.num_key_value_heads
    qkv = tq.qdense(x, att.qkv_proj)
    q, k, v = torch.split(qkv, [att.nq, att.nkv, att.nkv], dim=-1)
    q = old_rope(q.reshape(b, t, qh, hd), cos, sin)
    k = old_rope(k.reshape(b, t, kvh, hd), cos, sin)
    v = v.reshape(b, t, kvh, hd)
    if cache is None:
        return tq.qdense(tq.dense_attention(q, k, v, attn_bias, x.dtype), att.o_proj)
    if t == 1:
        ck = cache["k"]
        out = decode_attention(q[:, 0].to(ck.dtype), k[:, 0].to(ck.dtype), v[:, 0].to(ck.dtype), ck, cache["v"],
                               cache["index"], attn_bias[:, 0, :].float().contiguous(), layer)
        return tq.qdense(out.to(x.dtype).reshape(b, 1, att.nq), att.o_proj)
    i0 = int(cache["index"][0])
    cache["k"][layer, :, i0: i0 + t] = k.to(cache["k"].dtype)
    cache["v"][layer, :, i0: i0 + t] = v.to(cache["v"].dtype)
    k, v = cache["k"][layer].to(x.dtype), cache["v"][layer].to(x.dtype)
    return tq.qdense(tq.dense_attention(q, k, v, attn_bias, x.dtype), att.o_proj)


def old_qwen(model, emb, positions, attn_bias, cache=None):
    """Qwen2Model.forward as it was: each block closes its own residuals."""
    c = model.cfg
    cos, sin = tq.rope_cos_sin(positions, c.head_dim, c.rope_theta, dtype=emb.dtype)
    x = emb
    for i, blk in enumerate(model.layers):
        x = x + old_attention(blk.self_attn, old_rms(blk.input_layernorm, x), cos, sin, attn_bias, i, cache)
        x = x + blk.mlp(old_rms(blk.post_attention_layernorm, x))
    if cache is not None:
        cache["index"] += emb.shape[1]
    return old_rms(model.norm, x)


def old_mla_block(blk, x, cos, sin, attn_bias, layer, cache, stats):
    x = x + blk.self_attn(old_rms(blk.input_layernorm, x), cos, sin, attn_bias, layer, cache)
    h = old_rms(blk.post_attention_layernorm, x)
    return x + (blk.mlp(h, stats) if blk.is_moe else blk.mlp(h))


def old_mla(model, emb, positions, attn_bias, cache=None):
    c = model.cfg
    cos, sin = tq.rope_cos_sin(positions, c.qk_rope_head_dim, c.rope_theta, dtype=emb.dtype)
    stats = torch.zeros(len(mla_moe.COUNTERS), dtype=torch.int64)
    x = emb
    for i, blk in enumerate(model.layers):
        x = old_mla_block(blk, x, cos, sin, attn_bias, i, cache, stats)
    if cache is not None:
        cache["index"] += emb.shape[1]
    return old_rms(model.norm, x)


# ---- models and inputs ------------------------------------------------------------------------

def _randomize(module, seed, dtype):
    """N(0, 0.2) matrices in `dtype`; norms 1 + N(0, 0.1) and biases
    N(0, 0.2) kept in float32, as the port keeps its 1-D tensors."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=g) * (0.1 if "norm" in name else 0.2)
            p.copy_((1.0 if "norm" in name else 0.0) + noise)
            if p.dim() > 1:
                p.data = p.data.to(dtype)
    return module.eval()


def _qwen(dtype, seed=0, **cfg):
    from dataclasses import replace

    return _randomize(tq.Qwen2Model(replace(QWEN, **cfg)), seed, dtype)


def _mla(dtype, seed=0):
    return _randomize(mla_moe.MLAMoEModel(MLA), seed, dtype)


def _emb(dtype, b=B, t=T, d=64, seed=1):
    return torch.randn((b, t, d), generator=torch.Generator().manual_seed(seed)).to(dtype)


def _prefill_args(b=B, t=T, s=S):
    """positions (B, T) and a causal bias over S cache slots, the second row
    left-padded by two."""
    start = torch.tensor([0, 2], dtype=torch.int32)[:b]
    slot = torch.arange(t, dtype=torch.int32)[None, :]
    positions = torch.clamp(slot - start[:, None], min=0)
    allowed = (slot[0][None, :] <= slot[0][:, None])[None] & (slot >= start[:, None])[:, None, :]
    bias = torch.full((b, t, s), -1e10)
    bias[:, :, :t] = torch.where(allowed, 0.0, -1e10)
    return positions, bias


def _decode_args(b=B, t=T, s=S):
    positions = torch.full((b, 1), t, dtype=torch.int32)
    slot = torch.arange(s, dtype=torch.int32)[None, None, :]
    return positions, torch.where(slot <= t, 0.0, -1e10).to(torch.float32).expand(b, 1, s).contiguous()


# ---- the plain route --------------------------------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_is_the_old_chain(dtype, residual):
    g = torch.Generator().manual_seed(3)
    x, y = (torch.randn((B, T, 64), generator=g).to(dtype) for _ in range(2))
    norm = tq.RMSNorm(64, 1e-6)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(64, generator=g))
    want_x = x + y if residual else x
    got_x, got = rn.rms_norm_plain(x, norm.weight, norm.eps, y if residual else None)
    assert got.dtype == dtype and torch.equal(got, old_rms(norm, want_x)) and torch.equal(got_x, want_x)
    assert torch.equal(norm.residual(x, y if residual else None)[1], old_rms(norm, want_x))
    assert torch.equal(norm(want_x), old_rms(norm, want_x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_on_the_strided_latent_split(dtype):
    """kv_a_layernorm's input: the first kv_lora_rank columns of a (B, T,
    latent + rope) buffer, a view with the buffer's row stride."""
    g = torch.Generator().manual_seed(4)
    buf = torch.randn((B, T, MLA.latent_dim), generator=g).to(dtype)
    lat = buf.split([MLA.kv_lora_rank, MLA.qk_rope_head_dim], dim=-1)[0]
    norm = tq.RMSNorm(MLA.kv_lora_rank, MLA.rms_norm_eps)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(MLA.kv_lora_rank, generator=g))
    assert not lat.is_contiguous()
    assert torch.equal(norm(lat), old_rms(norm, lat.contiguous()))
    rn._check(lat, norm.weight, None)  # the kernel route reads the view as it is


# ---- the backbones, each residual left to the next norm ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qwen2_prefill_and_decode_step_are_the_old_chain(dtype):
    model = _qwen(dtype)
    emb = _emb(dtype)
    caches = [tq.init_cache(QWEN, B, S, dtype=torch.bfloat16) for _ in range(2)]
    with torch.no_grad():
        got = model(emb, *_prefill_args(), caches[0])
        want = old_qwen(model, emb, *_prefill_args(), caches[1])
        assert torch.equal(got, want)
        step = _emb(torch.bfloat16, t=1, seed=2)  # the decode runs in the cache's dtype
        got = model(step, *_decode_args(), caches[0])
        want = old_qwen(model, step, *_decode_args(), caches[1])
    assert torch.equal(got, want)
    assert all(torch.equal(caches[0][k], caches[1][k]) for k in ("k", "v", "index"))


def _quantize(model, seed=3):
    """Random int8 (or int4 nibble-pair) kernels, scales and biases in a
    quantized model's buffers."""
    g = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if buf.dtype == torch.int8:
            buf.copy_(torch.randint(-127, 128, buf.shape, generator=g, dtype=torch.int8))
        elif name.endswith("scale"):
            buf.copy_(0.002 + 0.001 * torch.rand(buf.shape, generator=g))
        elif name.endswith("bias"):
            buf.copy_(0.2 * torch.randn(buf.shape, generator=g))
    return model


@pytest.mark.parametrize("int4_mlp", [False, True])
def test_quantized_qwen2_is_the_old_chain(int4_mlp):
    """The int8 layers (and the int4 MLP): the product without its bias,
    the bias in the qkv epilogue, bit-equal to qdense's bias after it."""
    model = _quantize(_qwen(torch.float32, quant_int8=True, quant_int4_mlp=int4_mlp))
    emb = _emb(torch.float32)
    caches = [tq.init_cache(QWEN, B, S, dtype=torch.bfloat16) for _ in range(2)]
    with torch.no_grad():
        assert torch.equal(model(emb, *_prefill_args(), caches[0]), old_qwen(model, emb, *_prefill_args(), caches[1]))
        step = _emb(torch.bfloat16, t=1, seed=2)
        assert torch.equal(model(step, *_decode_args(), caches[0]), old_qwen(model, step, *_decode_args(), caches[1]))


@pytest.mark.parametrize("remat", ["", "full", "dots"])
def test_qwen2_training_forward_and_grads_are_the_old_chain(remat):
    """The cache-free forward with grad (the plain route), remat or not:
    output and every parameter's gradient bit-equal to the former chain's."""
    model = _qwen(torch.float32, remat=remat).train()
    emb = _emb(torch.float32).requires_grad_()
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    bias = tq.prefill_attn_bias(T, torch.tensor([T, T - 2], dtype=torch.int32))
    runs = []
    for fn in (model, lambda *a: old_qwen(model, *a)):
        model.zero_grad()
        emb.grad = None
        out = fn(emb, positions, bias)
        out.square().mean().backward()
        runs.append((out.detach(), emb.grad.clone(), [p.grad.clone() for p in model.parameters()]))
    (out, ge, gp), (want, we, wp) = runs
    assert torch.equal(out, want) and torch.equal(ge, we)
    assert len(gp) == len(wp) and all(torch.equal(a, b) for a, b in zip(gp, wp))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mla_blocks_are_the_old_chain(dtype):
    """The dense block and an MoE block in turn, the first one's MLP output
    added by the second one's input norm, the second one's closed by hand."""
    model = _mla(dtype)
    x = _emb(dtype)
    positions, bias = _prefill_args()
    cos, sin = tq.rope_cos_sin(positions, MLA.qk_rope_head_dim, MLA.rope_theta, dtype=dtype)
    stats = [torch.zeros(len(mla_moe.COUNTERS), dtype=torch.int64) for _ in range(2)]
    with torch.no_grad():
        want = x
        for i in range(2):
            want = old_mla_block(model.layers[i], want, cos, sin, bias, i, None, stats[1])
        got, y = x, None
        for i in range(2):
            got, y = model.layers[i](got, y, cos, sin, bias, i, None, stats[0])
        got = got + y
    assert torch.equal(got, want) and torch.equal(stats[0], stats[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mla_model_is_the_old_chain(dtype):
    """A whole MLAMoEModel forward: a prefill into the latent cache, then an
    absorbed decode step."""
    model = _mla(dtype)
    emb = _emb(dtype)
    caches = [model.init_cache(B, S, dtype=torch.bfloat16) for _ in range(2)]
    with torch.no_grad():
        assert torch.equal(model(emb, *_prefill_args(), caches[0]), old_mla(model, emb, *_prefill_args(), caches[1]))
        step = _emb(torch.bfloat16, t=1, seed=2)
        got = model(step, *_decode_args(), caches[0])
        want = old_mla(model, step, *_decode_args(), caches[1])
        assert torch.equal(got, want)
        assert torch.equal(caches[0]["kv"], caches[1]["kv"])
        assert torch.equal(model(emb, *_prefill_args()[:1], tq.prefill_attn_bias(T, torch.tensor([T, T]))),
                           old_mla(model, emb, *_prefill_args()[:1], tq.prefill_attn_bias(T, torch.tensor([T, T]))))


# ---- routes and counters ----------------------------------------------------------------------

def test_cpu_counts_norms_and_launches_nothing():
    model = _qwen(torch.float32)
    before = device.launches.copy()
    profiling.reset()
    with profiling.recording(), torch.no_grad():
        model(_emb(torch.float32), *_prefill_args(), tq.init_cache(QWEN, B, S))
    counters = profiling.counters()
    profiling.reset()
    n = QWEN.num_hidden_layers
    assert counters == {"llm.norms": 2 * n + 1, "llm.qkv": n}
    assert device.launches == before


@pytest.fixture
def stub_kernels(monkeypatch):
    """CPU tensors routed as the card's would be, with each launch replaced
    by the kernel route's checks and the plain version; the stubs' calls
    are recorded as (kernel, shape, with a residual or a bias)."""
    calls = []

    def norm(x, weight, eps, y=None):
        rn._check(x, weight, y)
        calls.append(("rms_norm", tuple(x.shape), y is not None))
        return rn.rms_norm_plain(x, weight, eps, y)

    def qkv(qkv_, bias, cos, sin, heads, kv_heads):
        qr._check(qkv_, bias, cos, sin, heads, kv_heads)
        calls.append(("qkv_rope", tuple(qkv_.shape), bias is not None))
        return qr.qkv_rope_plain(qkv_, bias, cos, sin, heads, kv_heads)

    for mod, fn, name in ((rn, norm, "rms_norm_fused"), (qr, qkv, "qkv_rope_fused")):
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(device, "KERNEL_DEVICES", ("cpu",))
    return calls


@pytest.mark.parametrize("route", ["prefill", "decode", "training", "compiling"])
def test_qwen2_route(stub_kernels, monkeypatch, route):
    """Inference (no grad), a prefill or a decode step in the cache's
    dtype, takes both kernels for every call; the training forward with
    grad and a compiler's trace take the plain route. The outputs are the
    plain route's in each case, and the counters follow the route."""
    model = _qwen(torch.float32)
    n = QWEN.num_hidden_layers
    cache = tq.init_cache(QWEN, B, S)
    if route == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    profiling.reset()
    with profiling.recording():
        if route == "training":
            model.train()
            out = model(_emb(torch.float32), torch.arange(T, dtype=torch.int32).expand(B, T),
                        tq.prefill_attn_bias(T, torch.tensor([T, T], dtype=torch.int32)))
            out.square().mean().backward()
            want = old_qwen(model, _emb(torch.float32), torch.arange(T, dtype=torch.int32).expand(B, T),
                            tq.prefill_attn_bias(T, torch.tensor([T, T], dtype=torch.int32)))
            assert all(p.grad is not None for p in model.parameters())
        else:
            with torch.no_grad():
                emb, args = ((_emb(torch.bfloat16, t=1), _decode_args()) if route == "decode"
                             else (_emb(torch.float32), _prefill_args()))
                if route == "decode":
                    cache = tq.init_cache(QWEN, B, S, dtype=torch.bfloat16)
                    cache["index"] += T
                out = model(emb, *args, {k: v.clone() for k, v in cache.items()})
                want = old_qwen(model, emb, *args, {k: v.clone() for k, v in cache.items()})
    counters = profiling.counters()
    profiling.reset()
    assert torch.equal(out.detach(), want.detach())
    if route in ("prefill", "decode"):
        t = 1 if route == "decode" else T
        assert counters == {"llm.norms": 2 * n + 1, "llm.fused_norms": 2 * n + 1, "llm.qkv": n, "llm.fused_qkv": n}
        assert sorted(set(stub_kernels)) == [("qkv_rope", (B, t, 128), True), ("rms_norm", (B, t, 64), False),
                                             ("rms_norm", (B, t, 64), True)]
        assert len(stub_kernels) == 3 * n + 1
    else:
        assert stub_kernels == [] and counters == {"llm.norms": 2 * n + 1, "llm.qkv": n}


def test_mla_route(stub_kernels):
    """The MLA-MoE backbone's three norms a layer and its final one take the
    kernel, kv_a_layernorm on its strided view of kv_a_proj's output; its
    rotation is not the Qwen2 epilogue and takes no kernel."""
    model = _mla(torch.bfloat16)
    n = MLA.num_hidden_layers
    profiling.reset()
    with profiling.recording(), torch.no_grad():
        cache = model.init_cache(B, S)
        model(_emb(torch.bfloat16), *_prefill_args(), cache)
        model(_emb(torch.bfloat16, t=1), *_decode_args(), cache)
    counters = profiling.counters()
    profiling.reset()
    assert counters == {"llm.norms": 2 * (3 * n + 1), "llm.fused_norms": 2 * (3 * n + 1)}
    assert {c[0] for c in stub_kernels} == {"rms_norm"}
    assert ("rms_norm", (B, 1, MLA.kv_lora_rank), False) in stub_kernels


# ---- the kernel route's refusals --------------------------------------------------------------

def _operands(**change):
    g = torch.Generator().manual_seed(7)
    ops = dict(x=torch.randn((B, T, 64), generator=g), weight=torch.randn(64, generator=g),
               y=torch.randn((B, T, 64), generator=g))
    ops.update(change)
    return ops


@pytest.mark.parametrize("bad", ["x_float16", "x_vector", "weight_shape", "weight_strided", "y_shape", "y_dtype",
                                 "y_device", "x_columns_strided"])
def test_kernel_route_refuses_what_it_cannot_read(bad):
    ops = _operands()
    change = {"x_float16": dict(x=ops["x"].half()), "x_vector": dict(x=ops["x"][0, 0], y=None),
              "weight_shape": dict(weight=ops["weight"][1:]),
              "weight_strided": dict(weight=torch.randn(128)[::2]), "y_shape": dict(y=ops["y"][:, 1:]),
              "y_dtype": dict(y=ops["y"].double()), "y_device": dict(y=ops["y"].to("meta")),
              "x_columns_strided": dict(x=ops["x"].transpose(1, 2).contiguous().transpose(1, 2)[:, :, :64],
                                        y=None)}[bad]
    ops.update(change)
    with pytest.raises(ValueError):
        rn._check(ops["x"], ops["weight"], ops["y"])


def test_kernel_route_refuses_grad():
    ops = _operands(x=torch.randn((B, T, 64), requires_grad=True))
    with pytest.raises(RuntimeError, match="no backward"):
        rn.rms_norm_fused(ops["x"], ops["weight"], 1e-6, ops["y"])


@pytest.mark.parametrize("case", ["cuda_inference", "cpu", "grad", "grad_disabled", "compiling", "none_skipped"])
def test_kernel_route_policy(monkeypatch, case):
    """ops/device.kernel_route, the policy both wrappers share: a kernel
    device's tensors take the kernel unless autograd records the call or a
    compiler traces it; the first tensor given decides the device."""
    x, w = torch.randn(2, 8), torch.randn(8)
    monkeypatch.setattr(device, "KERNEL_DEVICES", ("cuda",) if case == "cpu" else ("cpu",))
    if case == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    if case.startswith("grad"):
        w.requires_grad_()
    with torch.set_grad_enabled(case != "grad_disabled"):
        got = device.kernel_route(*((None, x, w, None) if case == "none_skipped" else (x, w)))
    assert got == (case in ("cuda_inference", "grad_disabled", "none_skipped"))


# ---- the benchmark's reader -------------------------------------------------------------------

@pytest.mark.parametrize("counters,want", [
    ({"llm.norms": 98, "llm.fused_norms": 98, "llm.qkv": 48, "llm.fused_qkv": 48}, 100.0),
    ({"llm.norms": 98, "llm.fused_norms": 98, "llm.qkv": 48}, 100.0 * 98 / 146),
    ({"llm.norms": 164}, 0.0), ({"llm.norms": 50, "llm.fused_norms": 25, "llm.qkv": 50, "llm.fused_qkv": 25}, 50.0),
    ({"llm.decode_steps": 3}, None)])
def test_fused_share_reader(counters, want):
    from benchmark.harness import Cell

    rec = {"name": "llm", "t0_ns": 100_100_000_000, "t1_ns": 100_200_000_000, "parent": None, "thread": 1,
           "request": 0, "attrs": {}}
    ctx = {"trace": SimpleNamespace(_host_perf=100.0, window_s=1.0, offset_ns=None),
           "program_records": ([rec], counters), "spans": [], "window_s": 1.0}
    for cell in ("cv3.datagen_b16", "cv3moon.datagen_b16"):
        assert Cell(cell).reader("llm_fused_pct.datagen")(dict(ctx)) == pytest.approx(want)
