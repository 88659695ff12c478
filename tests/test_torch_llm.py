"""fangyan_tts_torch.models.{qwen2,llm} against the JAX package with the
same weights (carried by models/from_jax.llm_from_jax), float32 models:
prefill logits rel <= 2e-4 with equal argmax; teacher-forced decode logits
(bf16 on both sides: decode runs in the cache dtype) within atol 2e-2 with
equal argmax; greedy tokens bit-equal over a whole generate_speech_tokens
run with one left-padded row among B=2. The same under the weight-only
int8 and int8+int4-MLP modes (JAX trees quantized by
quantize_qwen_params, carried by llm_from_jax): prefill and teacher-forced
decode logits with a float32 cache rel <= 2e-4 with equal argmax, and
greedy tokens bit-equal with B=3 ragged left-padded rows."""

from dataclasses import replace

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
from fangyan_tts_tpu.ops.quant import quantize_qwen_params
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


def _quant_models(int4_mlp: bool, seed=0):
    """The float32 LLM of _models(seed) quantized on the JAX side to int8
    (int4 MLP with int4_mlp) and carried to the port."""
    _, jp, _ = _models(seed)
    qj = replace(JC.llm, qwen=replace(JC.llm.qwen, quant_int8=True, quant_int4_mlp=int4_mlp))
    qt = replace(TC.llm, qwen=replace(TC.llm.qwen, quant_int8=True, quant_int4_mlp=int4_mlp))
    qp = quantize_qwen_params(jax.tree.map(np.asarray, jp), int4_mlp=int4_mlp)
    tm = tllm.CosyVoice3LM(qt, dtype=torch.float32)
    tm.load_state_dict(llm_from_jax(qp, qt), strict=True)
    return CosyVoice3LM(qj, dtype=jnp.float32), to_jax(qp), tm.eval()


def _batch(shapes=((9, 4), (5, 2))):
    """Prompts of (text, speech) lengths `shapes`, left-padded to TP (the
    default: two, the second shorter)."""
    rng = np.random.default_rng(7)
    plans = [build_prompt_plan(JC.llm, rng.integers(0, 300, n).tolist(), rng.integers(0, 50, m).tolist())
             for n, m in shapes]
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


@pytest.mark.parametrize("int4_mlp", [False, True])
def test_quantized_prefill_and_decode(int4_mlp):
    """float32 cache on both sides: the int8 / int4 products run in float32,
    where the port's plain versions are the JAX arithmetic exactly."""
    jm, jp, tm = _quant_models(int4_mlp)
    assert (tm.llm.layers[0].mlp.down_proj.bits, tm.llm.layers[0].self_attn.o_proj.bits) == ((4 if int4_mlp else 8), 8)
    jl, tl, _, _ = _prefill_and_decode(jm, jp, tm, [3, 17, 41], "float32")
    for a, b in zip(tl, jl):
        assert np.abs(a - b).max() / np.abs(b).max() <= 2e-4
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("int4_mlp", [False, True])
def test_quantized_greedy_generate_bit_equal(int4_mlp, seed):
    """Three ragged left-padded rows that stop at different steps."""
    jm, jp, tm = _quant_models(int4_mlp, seed)
    batch = _batch(((9, 4), (5, 2), (7, 0)))
    min_lens, max_lens = np.asarray([3, 5, 2], np.int32), np.asarray([24, 12, 18], np.int32)
    res = generate_speech_tokens(jm, jp, *(jnp.asarray(batch[k]) for k in ("src", "ids", "lengths")),
                                 jnp.asarray(min_lens), jnp.asarray(max_lens), jax.random.PRNGKey(0),
                                 max_new_tokens=32, cache_len=CACHE)
    got = tllm.generate_speech_tokens(tm, *(torch.from_numpy(batch[k]) for k in ("src", "ids", "lengths")),
                                      torch.from_numpy(min_lens), torch.from_numpy(max_lens),
                                      torch.Generator().manual_seed(0), max_new_tokens=32, cache_len=CACHE)
    np.testing.assert_array_equal(got.num_tokens.numpy(), np.asarray(res.num_tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(res.tokens))
    assert len(set(got.num_tokens.tolist())) > 1  # the rows stop at different steps


def test_greedy_generate_bit_equal_ragged_lengths():
    """Three rows whose min and max lengths all differ, so that the device
    step count's comparisons (i < min_len, i + 1 >= max_len) and the
    indexed write of out[:, i] act on each row at its own step."""
    jm, jp, tm = _models(3)
    batch = _batch(((9, 4), (5, 2), (7, 0)))
    min_lens, max_lens = np.asarray([0, 6, 2], np.int32), np.asarray([7, 30, 19], np.int32)
    res = generate_speech_tokens(jm, jp, *(jnp.asarray(batch[k]) for k in ("src", "ids", "lengths")),
                                 jnp.asarray(min_lens), jnp.asarray(max_lens), jax.random.PRNGKey(0),
                                 max_new_tokens=32, cache_len=CACHE)
    got = tllm.generate_speech_tokens(tm, *(torch.from_numpy(batch[k]) for k in ("src", "ids", "lengths")),
                                      torch.from_numpy(min_lens), torch.from_numpy(max_lens),
                                      torch.Generator().manual_seed(0), max_new_tokens=32, cache_len=CACHE)
    np.testing.assert_array_equal(got.num_tokens.numpy(), np.asarray(res.num_tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(res.tokens))
    assert len(set(got.num_tokens.tolist())) > 1


def test_ras_uniforms_are_the_samplers_own_draws():
    """Draws made ahead into buffers (what a replayed step samples from)
    are the numbers ras_sample draws itself, in its order: the same tokens,
    and the generator left where its own draws leave it, at top_k 25."""
    from fangyan_tts_torch.ops.sampling import _uniform, ras_sample, ras_uniforms

    b, v = 5, 58
    rng = torch.Generator().manual_seed(11)
    logp = torch.log_softmax(torch.randn((b, v), generator=rng) * 3, dim=-1)
    recent = torch.randint(-1, v, (b, 10), generator=rng, dtype=torch.int32)
    allowed = torch.arange(v)[None, :].expand(b, v) < 50
    g_own, g_ahead, g_ref = (torch.Generator().manual_seed(5) for _ in range(3))
    for _ in range(4):
        own = ras_sample(logp, recent, recent >= 0, allowed, g_own, top_k=25)
        u = (torch.empty((b, 25)), torch.empty((b, v)))
        ras_uniforms(u, g_ahead)
        assert torch.equal(u[0], _uniform((b, 25), g_ref, "cpu")) and torch.equal(u[1], _uniform((b, v), g_ref, "cpu"))
        ahead = ras_sample(logp, recent, recent >= 0, allowed, None, top_k=25, uniforms=u)
        assert torch.equal(own, ahead)
    assert torch.equal(g_own.get_state(), g_ahead.get_state())


def _decode_steps(num_tokens, max_lens, max_new: int) -> int:
    """The loop count generate_speech_tokens implies: row r is done after
    step n_r (its stop id) or, at its max length, after step n_r - 1."""
    done = [n - 1 if n >= m else n for n, m in zip(num_tokens, max_lens)]
    return min(max(done) + 1, max_new)


def test_graph_counters_on_the_cpu():
    """On the CPU every step runs eagerly: llm.graph_steps and
    llm.graph_captures are 0 and llm.decode_steps is the loop count."""
    from fangyan_tts_torch.utils import profiling

    _, _, tm = _models()
    batch = _batch(((9, 4), (5, 2), (7, 0)))
    min_lens, max_lens = np.asarray([3, 5, 2], np.int32), np.asarray([24, 12, 18], np.int32)
    profiling.reset()
    try:
        with profiling.recording():
            got = tllm.generate_speech_tokens(tm, *(torch.from_numpy(batch[k]) for k in ("src", "ids", "lengths")),
                                              torch.from_numpy(min_lens), torch.from_numpy(max_lens),
                                              torch.Generator().manual_seed(0), max_new_tokens=32, cache_len=CACHE)
        counters = profiling.counters()
    finally:
        profiling.reset()
    steps = _decode_steps(got.num_tokens.tolist(), max_lens.tolist(), 32)
    # the backbone's norms and qkv epilogues, on the plain route on the CPU: the prefill and every step's forward
    layers, forwards = tm.cfg.qwen.num_hidden_layers, 1 + steps
    assert counters == {"llm.decode_steps": steps, "llm.row_steps": 3 * steps, "llm.graph_steps": 0,
                        "llm.graph_captures": 0, "llm.norms": (2 * layers + 1) * forwards,
                        "llm.qkv": layers * forwards}


CUDA = torch.device("cuda")  # the store's rules read only the device's type: nothing here reaches a card


def _shape(max_new=32, cache=CACHE):
    return (2, max_new, cache, tllm.CACHE_DTYPE)


def test_graph_store_decides_eager():
    """Off the card, and for a model with a tensor-parallel layer, the
    decode runs eagerly: no bucket."""
    from fangyan_tts_torch.models import decode_graphs
    from fangyan_tts_torch.parallel.sharding import TPLinear

    _, _, tm = _models()
    made = []
    make = lambda: made.append(object()) or made[-1]
    assert decode_graphs.eligible(tm, CUDA) and not decode_graphs.eligible(tm, torch.device("cpu"))
    with decode_graphs.bucket(tm, _shape(), torch.device("cpu"), make) as got:
        assert got is None
    tm.llm.layers[1].self_attn.o_proj.__class__ = TPLinear
    assert not decode_graphs.eligible(tm, CUDA)
    with decode_graphs.bucket(tm, _shape(), CUDA, make) as got:
        assert got is None
    assert made == []


def test_graph_store_keys_and_versions():
    """A bucket is reused under its key; another shape, inference mode or
    config is another bucket; a bucket in use is not shared (the second
    decode runs eagerly); a parameter's version bumped, or a module
    swapped, drops the graph and keeps the state for a new capture."""
    from dataclasses import replace as dc_replace

    from fangyan_tts_torch.models import decode_graphs

    _, _, tm = _models()
    make = lambda: object()
    with decode_graphs.bucket(tm, _shape(), CUDA, make) as first:
        first.graph = "captured"
        with decode_graphs.bucket(tm, _shape(), CUDA, make) as busy:
            assert busy is None
    with decode_graphs.bucket(tm, _shape(), CUDA, make) as again:
        assert again is first and again.graph == "captured"
    for other in (_shape(max_new=64, cache=80), _shape(cache=64)):
        with decode_graphs.bucket(tm, other, CUDA, make) as got:
            assert got is not first
    with torch.inference_mode(), decode_graphs.bucket(tm, _shape(), CUDA, make) as got:
        assert got is not first
    tm.cfg = dc_replace(tm.cfg, top_k=25)
    with decode_graphs.bucket(tm, _shape(), CUDA, make) as got:
        assert got is not first
    tm.cfg = dc_replace(tm.cfg, top_k=1)
    state = first.state
    with torch.no_grad():
        tm.llm.norm.weight.mul_(1.0)  # same values, a new version
    with decode_graphs.bucket(tm, _shape(), CUDA, make) as got:
        assert got is first and got.graph is None and got.state is state
    got.graph = "captured"
    tm.llm_decoder = torch.nn.Linear(*tm.llm_decoder.weight.shape[::-1], bias=False)  # a swapped module
    with decode_graphs.bucket(tm, _shape(), CUDA, make) as got:
        assert got is first and got.graph is None


def test_graph_store_lru_frees_buckets():
    """At most MAX_BUCKETS buckets a model: the least recently used goes,
    with its state; the store lets go of a model that is gone."""
    import gc
    import weakref

    from fangyan_tts_torch.models import decode_graphs

    class State:
        pass

    _, _, tm = _models()
    states = []
    make = lambda: states.append(State()) or states[-1]
    n = decode_graphs.MAX_BUCKETS + 2
    for k in range(n):
        with decode_graphs.bucket(tm, _shape(max_new=32 * (k + 1), cache=64 * (k + 1)), CUDA, make):
            pass
    with decode_graphs.bucket(tm, _shape(max_new=32 * 3, cache=64 * 3), CUDA, make) as got:
        assert got.state is states[2]  # the third stays, and is now the most recently used
    refs = [weakref.ref(s) for s in states]
    del states[:]
    gc.collect()
    assert [r() is None for r in refs] == [True, True] + [False] * (n - 2)
    model = weakref.ref(tm)
    del tm, got
    gc.collect()
    assert model() is None and all(r() is None for r in refs)


def test_graph_captures_take_turns_on_a_device(monkeypatch):
    """Two threads capturing buckets of one device at once take turns (they
    share its capture stream): the recording, stubbed here, never runs in
    both at the same time; each bucket gets its graph and its tally."""
    import collections
    import threading
    import time
    from types import SimpleNamespace

    from fangyan_tts_torch.models import decode_graphs

    active, most, lock = [0], [0], threading.Lock()

    def record(step, dev):
        with lock:
            active[0] += 1
            most[0] = max(most[0], active[0])
        time.sleep(0.05)
        step()
        with lock:
            active[0] -= 1
        return f"graph of {dev}", collections.Counter(decode_attention=24)

    monkeypatch.setattr(decode_graphs, "_record", record)
    buckets = [decode_graphs.Bucket(SimpleNamespace(out=torch.zeros(1)), ()) for _ in range(2)]
    ran, start = [], threading.Barrier(2)

    def capture(b):
        start.wait()
        b.capture(lambda: ran.append(b))

    threads = [threading.Thread(target=capture, args=(b,)) for b in buckets]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert most[0] == 1 and sorted(map(id, ran)) == sorted(map(id, buckets))  # one recording a bucket
    assert all(b.graph == "graph of cpu" and b.launches == {"decode_attention": 24} for b in buckets)


def test_graph_bucket_keyed_on_the_cache_it_holds(monkeypatch):
    """The bucket's key carries the dtype of the cache init_cache makes for
    its state, so a bucket made while caches are float32 is not reused for
    a bf16 one."""
    from fangyan_tts_torch.models import decode_graphs, qwen2

    _, _, tm = _models()
    keys = []
    monkeypatch.setattr(decode_graphs, "eligible", lambda model, device: True)
    monkeypatch.setattr(decode_graphs, "bucket", lambda model, shape, device, make: keys.append(shape))
    tllm._bucket(tm, 2, 32, CACHE, CUDA)
    inner = qwen2.init_cache
    monkeypatch.setattr(qwen2, "init_cache", lambda cfg, b, n, dtype=None, device=None:
                        inner(cfg, b, n, torch.float32, device))
    tllm._bucket(tm, 2, 32, CACHE, CUDA)
    assert keys == [(2, 32, CACHE, torch.bfloat16), (2, 32, CACHE, torch.float32)]


def _launch_decode_attention():
    """One bf16 launch through decode_attention's launching code on CPU
    tensors, the C entry stubbed."""
    from fangyan_tts_torch.ops import decode_attention as da

    q, kv = torch.zeros((1, 2, 64), dtype=torch.bfloat16), torch.zeros((1, 1, 64), dtype=torch.bfloat16)
    cache = torch.zeros((1, 1, 16, 1, 64), dtype=torch.bfloat16)
    da._launch(q, kv, kv, cache, cache, torch.zeros(1, dtype=torch.int32), torch.zeros((1, 16)), 0)


def _launch_flash_attention():
    """One bf16 launch through the CUDA kernel of fangyan::chunk_flash_attention
    on CPU tensors, the C entry stubbed."""
    from fangyan_tts_torch.ops import flash_attention as fa

    x = torch.zeros((1, 1, 8, 64), dtype=torch.bfloat16)
    fa._cuda(x, x, x, torch.tensor([8], dtype=torch.int32), 0)


@pytest.mark.parametrize("route, launch", [
    ("decode_attention", None), ("decode_attention", _launch_decode_attention),
    ("chunk_flash_attention", _launch_flash_attention),
], ids=["launched", "decode_attention", "chunk_flash_attention"])
def test_captured_launches_are_tallied_for_the_graph(monkeypatch, route, launch):
    """A launch adds 1 to its route in ops/device.launches, or, while its
    stream captures, nothing there and 1 to the tally of the graph being
    captured: by device.launched itself, and by the launching code of the
    decode-attention and flash-attention wrappers."""
    import collections
    from types import SimpleNamespace

    from fangyan_tts_torch.ops import _build, device
    from fangyan_tts_torch.ops import flash_attention as fa

    capturing = [False]  # the stream's state, as the card would report it
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "load", lambda entry: lambda *args: 0)  # the C entry: launches nothing, succeeds
    monkeypatch.setattr(fa, "_check", lambda *args: None)  # its checks read the current CUDA device
    monkeypatch.setattr(device, "launches", collections.Counter())
    launch = launch or (lambda: device.launched(route))
    launch()
    assert device.launches == {route: 1}
    capturing[0] = True
    launch()  # no capture of this thread's to tally for
    assert device.launches == {route: 1}
    with device.captured_launches() as tally:
        launch()
        launch()
        device.launched("int4_matmul_f32")
    assert tally == {route: 2, "int4_matmul_f32": 1} and device.launches == {route: 1}
    launch()
    assert tally[route] == 2 and device.launches == {route: 1}
