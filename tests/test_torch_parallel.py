"""fangyan_tts_torch/parallel against the JAX package's parallel/ and its
tests/test_mesh_sharding.py contract, on the CPU with gloo process groups
(parallel/launch.Group; the per-process halves are
tests/torch_parallel_ranks.py, which imports no JAX):

- placements: every parameter of the tiny LM and DiT flow, their int8
  variants, and the same at CosyVoice3-0.5B's widths (meta tensors), under
  dp2 x fsdp2 x tp2, tp2, fsdp2, fsdp8 and dp8, equal the JAX param_pspec of
  the matching JAX path and shape, transposed (one process, no spawn);
- 8 processes, dp2 x fsdp2 x tp2: each one's parameter and optimizer-slot
  shapes are the rule's slices (two layers of one shape keep their own);
  LLM steps (accum 1 and 2) and flow steps (the JAX draws) give the
  unsharded port step's loss and acc within 1e-5 and its parameters within
  2e-5, and the JAX unsharded step's loss within 2e-4 relative; a
  checkpoint saved under the mesh is the single-device one and loads
  sliced; an fsdp=8 step (a 2**16-element embedding sharded) as above;
- 2 processes, tp=2: greedy decode tokens equal the port's one-process
  run and the JAX package's (float32, int8 and int8 with the int4 MLP,
  whose packed rows split on whole bytes), teacher-forced
  logits within 2e-4 of the JAX package's; two shard_token2wav flow hops
  within 2e-4 of one process and of the JAX package's; make_mesh and
  shard_module refuse a world or a head count that does not fit;
- 2 processes, dp=2: a DPO step and the GAN turns equal one process;
- dryrun_multichip(8) on the CPU exits 0 (its sharded steps held to unsharded ones, its
  TP decode and token2wav to one process).

Each process group runs once, in a module fixture, while the fixture makes
the references, with one torch thread a process and a join timeout; JAX is
imported inside the fixtures and tests only.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from fangyan_tts_torch.parallel.launch import Group

GROUP_TIMEOUT = 180  # seconds a process group may take (from its start) before it is killed
MESHES = {"dp2xfsdp2xtp2": dict(dp=2, fsdp=2, tp=2), "tp2": dict(tp=2), "fsdp2": dict(fsdp=2),
          "fsdp8": dict(fsdp=8), "dp8": dict(dp=8)}
MODELS = ("llm", "llm_int8", "flow", "flow_int8", "llm_full", "llm_full_int8", "flow_full", "flow_full_int8")


# ---------------------------------------------------------------- placements


@functools.lru_cache(maxsize=None)
def _models(kind: str):
    """(JAX param shapes (ShapeDtypeStructs), the port's module on meta
    tensors) of one placement case (built once a kind, read only)."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    import fangyan_tts_torch.config as tcfg
    import fangyan_tts_tpu.config as jcfg
    from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT as TFlow
    from fangyan_tts_torch.models.llm import CosyVoice3LM as TLM
    from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT as JFlow
    from fangyan_tts_tpu.models.llm import CosyVoice3LM as JLM
    from fangyan_tts_tpu.ops.quant import quantize_dit_params, quantize_qwen_params
    from torch_port_util import configs

    int8 = kind.endswith("int8")
    jc, tc = (configs(m) if "full" not in kind else m.CosyVoiceConfig() for m in (jcfg, tcfg))
    if kind.startswith("llm"):
        jc, tc = (replace(c.llm, qwen=replace(c.llm.qwen, quant_int8=int8)) for c in (jc, tc))
        t = jnp.zeros((1, 8), jnp.int32)
        shapes = jax.eval_shape(lambda: JLM(jc).init(jax.random.PRNGKey(0), t, t, jnp.asarray([8]), t))["params"]
        if int8:
            shapes = jax.eval_shape(quantize_qwen_params, shapes)
        with torch.device("meta"):
            return shapes, TLM(tc)
    jc, tc = (replace(c.flow, dit=replace(c.flow.dit, quant_int8=int8)) for c in (jc, tc))
    t = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: JFlow(jc).init(jax.random.PRNGKey(0), t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                                                   jnp.asarray([16]), jnp.zeros((1, 192)), jax.random.PRNGKey(1)))
    shapes = shapes["params"]
    if int8:
        shapes = jax.eval_shape(quantize_dit_params, shapes)
    with torch.device("meta"):
        return shapes, TFlow(tc)


def _jax_expected(shapes, sizes: dict) -> dict:
    """{port name: the JAX param_pspec of its JAX leaf, the layer axis taken
    off and the dims put in torch's order}."""
    import types

    import jax

    from fangyan_tts_torch.models.from_jax import _STACKED, _TO_TORCH
    from fangyan_tts_tpu.parallel.sharding import param_pspec

    mesh = types.SimpleNamespace(shape=sizes)
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = [str(getattr(k, "key", k)) for k in keypath]
        spec = tuple(param_pspec("/".join(path), leaf.shape, mesh))
        spec = spec + (None,) * (len(leaf.shape) - len(spec))
        s = next((i for i, p in enumerate(path) if p in _STACKED), None)
        layers = [None] if s is None else range(leaf.shape[0])
        if s is not None:
            assert spec[0] is None, f"the JAX rule shards the layer axis of {path}"
            spec = spec[1:]
        last = path[-1]
        permuted = last == "kernel" or last.endswith("_kernel")
        torch_spec = tuple(spec[j] for j in _TO_TORCH[len(spec)]) if permuted else spec
        for i in layers:
            mods = path[:-1] if s is None else path[: s + 1] + [str(i)] + path[s + 1 : -1]
            if last == "kernel":
                name = mods + ["weight"]
            elif last.endswith("_kernel"):
                name = mods + [last[: -len("_kernel")], "weight"]
            elif last.endswith("_bias"):
                name = mods + [last[: -len("_bias")], "bias"]
            elif last == "embedding":
                name = mods + ["weight"]
            else:
                name = mods + [last]
            out[".".join(name)] = torch_spec
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", MODELS)
def test_placements_match_jax_rules(kind, mesh):
    from fangyan_tts_torch.parallel import placement_tree

    shapes, module = _models(kind)
    want = _jax_expected(shapes, {"dp": 1, "fsdp": 1, "tp": 1, **MESHES[mesh]})
    got = placement_tree(module, MESHES[mesh])
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    if mesh in ("tp2", "dp2xfsdp2xtp2"):
        assert any("tp" in v for v in got.values())


# ---------------------------------------------------------------- 8 processes: training


def _port_llm_step(cfg, sd: dict, batch: dict, accum: int):
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import trainer
    from fangyan_tts_torch.train.scheduler import build_optimizer

    m = ranks._module(lambda: CosyVoice3LM(cfg, dtype=torch.float32), sd).train()
    tx = build_optimizer(lr=1e-3, scheduler="constantlr")
    _, metrics = trainer.make_llm_train_step(m, tx, accum=accum)(trainer.init_state(m, tx), batch)
    return {k: float(v) for k, v in metrics.items()}, ranks._np(m.state_dict())


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """The 8-process group's results beside the port's unsharded steps and
    the JAX package's unsharded steps on the same weights and batches."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from fangyan_tts_torch.data.dataset import stack_microbatches
    from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import trainer
    from fangyan_tts_torch.train.scheduler import build_optimizer
    from fangyan_tts_tpu.train import scheduler as jsched
    from fangyan_tts_tpu.train import trainer as jtrainer
    from test_torch_train_models import flow_batch, flow_models, jax_draws, llm_batch, llm_models
    from torch_port_util import both, to_jax

    JC, TC = both()
    jm, p, tm = llm_models(JC.llm, TC.llm, seed=7)
    fjm, fp, ftm = flow_models(3)
    rows8 = (12, 9, 6, 12, 10, 8, 12, 7)
    lb = {1: llm_batch(1, b=8), 2: next(stack_microbatches(iter([llm_batch(2, b=8), llm_batch(3, b=8)]), 2))}
    fb = {1: flow_batch(4, rows8), 2: next(stack_microbatches(iter([flow_batch(5, rows8), flow_batch(6, rows8)]), 2))}
    shape = fb[1]["feat"].shape
    key = jax.random.PRNGKey(20)
    fkeys = {1: [key], 2: list(jax.random.split(key, 2))}
    draws = {a: [{k: v.numpy() for k, v in jax_draws(r, shape[0], shape).items()} for r in fkeys[a]] for a in (1, 2)}
    big_cfg = replace(TC.llm, qwen=replace(TC.llm.qwen, vocab_size=1024))
    torch.manual_seed(0)
    big_sd = ranks._np(CosyVoice3LM(big_cfg).state_dict())
    job = {"llm_cfg": TC.llm, "llm_sd": ranks._np(tm.state_dict()), "llm_batch1": lb[1], "llm_batch2": lb[2],
           "flow_cfg": TC.flow, "flow_sd": ranks._np(ftm.state_dict()), "flow_batch1": fb[1], "flow_batch2": fb[2],
           "flow_draws1": draws[1], "flow_draws2": draws[2], "big_cfg": big_cfg, "big_sd": big_sd,
           "big_batch": llm_batch(8, b=8), "ckpt": str(tmp_path_factory.mktemp("ckpt") / "llm.msgpack")}
    group = Group(ranks.train_rank, 8, args=(job,), timeout=GROUP_TIMEOUT)  # runs while the references are made

    ref = {}
    jtx = jsched.build_optimizer(lr=1e-3, scheduler="constantlr")
    for a in (1, 2):
        ref[f"llm{a}"], ref[f"llm{a}_params"] = _port_llm_step(TC.llm, job["llm_sd"], lb[a], a)
        _, jmet = jtrainer.make_llm_train_step(jm, jtx, accum=a)(jtrainer.init_state(to_jax(p), jtx),
                                                                  {k: jnp.asarray(v) for k, v in lb[a].items()},
                                                                  jax.random.PRNGKey(0))
        ref[f"jax_llm{a}"] = float(jmet["loss"])
        flow = ranks._module(lambda: CausalMaskedDiffWithDiT(TC.flow), job["flow_sd"]).train()
        tx = build_optimizer(lr=1e-3, scheduler="constantlr")
        d = [{k: torch.from_numpy(v) for k, v in x.items()} for x in draws[a]]
        _, met = trainer.make_flow_train_step(flow, tx, accum=a)(trainer.init_state(flow, tx), fb[a],
                                                                 d[0] if a == 1 else d)
        ref[f"flow{a}"], ref[f"flow{a}_params"] = {k: float(v) for k, v in met.items()}, ranks._np(flow.state_dict())
        ref[f"flow{a}_noise"] = _noise_elements(TC.flow, job["flow_sd"], fb[a], d)
        _, jmet = jtrainer.make_flow_train_step(fjm, jtx, accum=a)(
            jtrainer.init_state(to_jax(fp), jtx), {k: jnp.asarray(v) for k, v in fb[a].items()}, key)
        ref[f"jax_flow{a}"] = float(jmet["loss"])
    ref["big"], ref["big_params"] = _port_llm_step(big_cfg, big_sd, job["big_batch"], 1)
    return group.join(), ref, job


def _noise_elements(cfg, sd: dict, batch: dict, draws: list) -> dict:
    """Per flow parameter, True where the float32 gradient of the step (the
    mean over its microbatches) is off the float64 one by over 1e-3 of it:
    gradients that are rounding noise, as the key projection's bias's (zero
    in exact arithmetic: the softmax removes a shift shared by every key).
    Adam divides each gradient by its own size, so there a step moves by up
    to lr either way, however the sums are ordered, and the 2e-5 limit of
    the other parameters cannot hold; those elements are held to 2 lr."""
    from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT
    from fangyan_tts_torch.train.trainer import FLOW_KEYS

    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = ranks._module(lambda: CausalMaskedDiffWithDiT(cfg), sd).to(dtype)
        stacked = len(draws) > 1
        total = None
        for i, d in enumerate(draws):
            args = [torch.from_numpy(np.asarray(batch[k][i] if stacked else batch[k])) for k in FLOW_KEYS]
            args = [a.to(dtype) if a.is_floating_point() else a for a in args]
            loss, _ = m(*args, {k: v.to(dtype) if v.is_floating_point() else v for k, v in d.items()})
            g = torch.autograd.grad(loss, list(m.parameters()))
            total = g if total is None else [a + b for a, b in zip(total, g)]
        grads[dtype] = dict(zip([n for n, _ in m.named_parameters()], total))
    return {k: ((g - grads[torch.float64][k]).abs() > 1e-3 * grads[torch.float64][k].abs()).numpy()
            for k, g in grads[torch.float32].items()}


def _held(got: dict, want: dict, metrics: dict, gparams: dict, wparams: dict, noise: dict | None = None) -> None:
    for k in metrics:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert sorted(gparams) == sorted(wparams)
    for k, w in wparams.items():
        skip = noise[k] if noise and k in noise else np.zeros(np.shape(w), bool)
        assert skip.mean() < 0.5, (k, skip.mean())
        np.testing.assert_allclose(gparams[k][~skip], w[~skip], rtol=2e-5, atol=2e-5, err_msg=k)
        assert np.abs(gparams[k][skip] - w[skip]).max(initial=0.0) <= 2 * 1e-3, k


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_llm_step_matches_unsharded(train_run, accum):
    res, ref, _ = train_run
    for r in res:  # every process reports the same (global) metrics
        _held(r[f"llm{accum}"], ref[f"llm{accum}"], ("loss", "acc", "grad_norm"), res[0][f"llm{accum}_params"],
              ref[f"llm{accum}_params"])
    want = ref[f"jax_llm{accum}"]
    assert abs(res[0][f"llm{accum}"]["loss"] - want) <= 2e-4 * abs(want)


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_flow_step_matches_unsharded(train_run, accum):
    res, ref, _ = train_run
    keys = ("loss", "grad_norm") + (("loss_cfm",) if accum == 1 else ())
    for r in res:
        _held(r[f"flow{accum}"], ref[f"flow{accum}"], keys, res[0][f"flow{accum}_params"], ref[f"flow{accum}_params"],
              ref[f"flow{accum}_noise"])
    want = ref[f"jax_flow{accum}"]
    assert abs(res[0][f"flow{accum}"]["loss"] - want) <= 2e-4 * abs(want)


def test_fsdp_step_matches_unsharded(train_run):
    res, ref, _ = train_run
    for r in res:
        _held(r["big"], ref["big"], ("loss", "acc", "grad_norm"), res[0]["big_params"], ref["big_params"])
    # the embedding (1024 x 64 = 2**16 elements) was sharded over fsdp, its largest dim
    assert res[0]["big_shapes"]["params"]["embed_tokens.weight"] == (1024 // 8, 64)


def _rule_slice(full: tuple, spec: tuple, sizes: dict) -> tuple:
    return tuple(n // sizes[a] if a else n for n, a in zip(full, spec))


@pytest.mark.parametrize("which", ["llm", "flow"])
def test_local_shapes_follow_rules(train_run, which):
    res, _, job = train_run
    full = {k: np.shape(v) for k, v in job[f"{which}_sd"].items()}
    sizes = {"dp": 2, "fsdp": 2, "tp": 2}
    for r in res:
        place, shapes = r[f"{which}_placements"], r[f"{which}_shapes"]
        want = {k: _rule_slice(full[k], place[k], sizes) for k in full}
        assert {**shapes["params"], **shapes["buffers"]} == want
        assert len(shapes["slots"]) == 2  # adam's mu and nu
        for slot in shapes["slots"]:
            assert slot == shapes["params"]
    assert any("tp" in v for v in res[0][f"{which}_placements"].values())


def test_equal_shaped_layers_keep_their_placements(train_run):
    res, _, _ = train_run
    for r in res:
        place, shapes = r["pair_placements"], r["pair_shapes"]
        assert place["self_attn.qkv_proj.weight"] == ("tp", None)
        assert place["self_attn.o_proj.weight"] == (None, "tp")
        assert shapes["params"]["self_attn.qkv_proj.weight"] == (32, 64)
        assert shapes["params"]["self_attn.o_proj.weight"] == (64, 32)
        assert len(shapes["slots"]) == 3  # the MultiSteps accumulator, adam's mu and nu
        for slot in shapes["slots"]:
            assert slot == shapes["params"]


def test_checkpoint_under_mesh_loads_into_one_process(train_run):
    from fangyan_tts_torch.models.from_jax import convert
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train.checkpoint import load_meta, load_params

    res, ref, job = train_run
    with torch.device("meta"):
        skeleton = CosyVoice3LM(job["llm_cfg"])
    got = convert(load_params(job["ckpt"]), skeleton)
    for k, v in res[0]["llm1_params"].items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)  # the gathered tensors, bit for bit
    assert load_meta(job["ckpt"]) == {"epoch": 0, "step": 1}
    assert all(r["ckpt_local_equal"] for r in res)  # read back and sliced by the rules on every process


# ---------------------------------------------------------------- 2 processes: tensor-parallel inference


@pytest.fixture(scope="module")
def tp_run():
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from fangyan_tts_torch.models.from_jax import flow_from_jax, hift_from_jax, llm_from_jax
    from fangyan_tts_tpu import config as jcfg
    from fangyan_tts_tpu.data.lm_plan import build_prompt_plan, pad_plans_left
    from fangyan_tts_tpu.infer.stream import FlowStream
    from fangyan_tts_tpu.infer.tts import CosyVoice3TTS
    from fangyan_tts_tpu.models import qwen2 as jq
    from fangyan_tts_tpu.models.llm import CosyVoice3LM, generate_speech_tokens
    from fangyan_tts_tpu.ops.quant import quantize_qwen_params
    from test_torch_train_models import llm_batch
    import fangyan_tts_torch.config as tcfg
    from torch_port_util import both, np_params, to_jax

    JC, TC = both()
    jm = CosyVoice3LM(JC.llm, dtype=jnp.float32)
    t = jnp.zeros((1, 4), jnp.int32)
    p = np_params(jm, 0, t, t, jnp.asarray([4]), t, gain=0.5)
    qj, qt = (replace(c.llm, qwen=replace(c.llm.qwen, quant_int8=True)) for c in (JC, TC))
    qp = quantize_qwen_params(jax.tree.map(np.asarray, p))
    q4j, q4t = (replace(c.llm, qwen=replace(c.llm.qwen, quant_int8=True, quant_int4_mlp=True)) for c in (JC, TC))
    q4p = quantize_qwen_params(jax.tree.map(np.asarray, p), int4_mlp=True)
    rng = np.random.default_rng(7)
    plans = [build_prompt_plan(JC.llm, rng.integers(0, 300, n).tolist(), rng.integers(0, 50, m).tolist())
             for n, m in ((9, 4), (5, 2))]
    decode = {k: np.asarray(v) for k, v in pad_plans_left(plans, length=16).items()}
    decode = {"src": decode["src"], "ids": decode["ids"], "lens": decode["lengths"],
              "min_lens": np.full(2, 4, np.int32), "max_lens": np.full(2, 20, np.int32)}
    plan = llm_batch(11, b=2)

    # the token2wav config of the JAX package's test_tp_sharded_flow_stream_matches_single
    def tts_cfg(mod):
        return mod.CosyVoiceConfig(
            llm=mod.LLMConfig(llm_input_size=32, llm_output_size=32, speech_token_size=64, extra_tokens=8,
                              qwen=mod.QwenConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                                  num_attention_heads=2, num_key_value_heads=1, head_dim=16,
                                                  vocab_size=128)),
            flow=mod.FlowConfig(vocab_size=64, n_timesteps=2, dit=mod.DiTConfig(dim=32, depth=2, heads=2, dim_head=16,
                                                                               ff_mult=2, static_chunk_size=50)),
            hift=mod.HiFTConfig(base_channels=32, f0_cond_channels=16, stream_noise_seconds=2))

    jtts = CosyVoice3TTS.random_init(tts_cfg(jcfg), dtype=jnp.float32)
    jtts.stream_window_tokens = 50
    tc = tts_cfg(tcfg)
    sds = [fn(jax.device_get(ps), c) for fn, ps, c in ((llm_from_jax, jtts.llm_params, tc.llm),
                                                        (flow_from_jax, jtts.flow_params, tc.flow),
                                                        (hift_from_jax, jtts.hift_params, tc.hift))]
    tok = np.random.default_rng(0)
    job = {"llm_cfg": TC.llm, "llm_sd": ranks._np(llm_from_jax(p, TC.llm)),
           "llm_int8_cfg": qt, "llm_int8_sd": {k: v.numpy() for k, v in llm_from_jax(qp, qt).items()},
           "llm_int4_cfg": q4t, "llm_int4_sd": {k: v.numpy() for k, v in llm_from_jax(q4p, q4t).items()},
           "decode": decode, "max_new": 20, "cache_len": 48, "plan": plan,
           "tts_cfg": tc, "tts_sds": [{k: v.numpy() for k, v in sd.items()} for sd in sds], "window": 50,
           "tokens": tok.integers(0, 60, size=80).astype(np.int32),
           "emb": tok.standard_normal(192).astype(np.float32)}
    group = Group(ranks.tp_rank, 2, args=(job,), timeout=GROUP_TIMEOUT)
    one = ranks.one_process(job)

    jax_out = {}
    for label, cfg, params in (("f32", JC.llm, to_jax(p)), ("int8", qj, to_jax(qp)), ("int4", q4j, to_jax(q4p))):
        model = CosyVoice3LM(cfg, dtype=jnp.float32)
        out = generate_speech_tokens(model, params, *(jnp.asarray(decode[k]) for k in
                                                      ("src", "ids", "lens", "min_lens", "max_lens")),
                                     jax.random.PRNGKey(7), max_new_tokens=20, cache_len=48)
        bound = model.bind({"params": params})
        n = plan["ids"].shape[1]
        x = bound.embed_plan(jnp.asarray(plan["src"]), jnp.asarray(plan["ids"]))
        pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (2, n))
        h, _ = bound.llm(x, pos, jq.prefill_attn_bias(n, jnp.asarray(plan["lengths"])))
        jax_out[label] = {"tokens": np.asarray(out.tokens), "num": np.asarray(out.num_tokens),
                          "logits": np.asarray(bound.llm_decoder(h), np.float32)}
    fs = FlowStream(jtts, np.zeros(0, np.int32), np.zeros((0, 80), np.float32), job["emb"], prompt_pad=0)
    jax_out["hops"] = [np.asarray(fs.step(job["tokens"])) for _ in range(2)]
    return group.join(), one, jax_out


@pytest.mark.parametrize("weights", ["f32", "int8", "int4"])
def test_tp_decode_matches_one_process(tp_run, weights):
    res, one, jax_out = tp_run
    for r in res:
        np.testing.assert_array_equal(r[weights]["num"], one[weights]["num"])
        np.testing.assert_array_equal(r[weights]["tokens"], one[weights]["tokens"])
    np.testing.assert_array_equal(res[0][weights]["num"], jax_out[weights]["num"])
    np.testing.assert_array_equal(res[0][weights]["tokens"], jax_out[weights]["tokens"])
    assert one[weights]["num"].min() > 4  # the decodes ran past min_len


@pytest.mark.parametrize("weights", ["f32", "int8", "int4"])
def test_tp_teacher_forced_logits_match_jax(tp_run, weights):
    res, one, jax_out = tp_run
    want = jax_out[weights]["logits"]
    for r in res:
        rel = np.abs(r[weights]["logits"] - want).max() / np.abs(want).max()
        assert rel <= 2e-4, rel
        np.testing.assert_allclose(r[weights]["logits"], one[weights]["logits"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("hop", [0, 1])
def test_tp_token2wav_hops_match(tp_run, hop):
    """Hop 1 runs the KV-cached young estimator, hop 2 the windowed solve
    (the flash-attention route)."""
    res, one, jax_out = tp_run
    for r in res:
        assert r["hops"][hop].shape == (1, 50, 80)
        np.testing.assert_allclose(r["hops"][hop], one["hops"][hop], rtol=0, atol=2e-4)
        np.testing.assert_allclose(r["hops"][hop], jax_out["hops"][hop], rtol=0, atol=2e-4)


@pytest.mark.parametrize("what", ["mismatch", "heads"])
def test_mesh_refusals(tp_run, what):
    res, _, _ = tp_run
    msg = {"mismatch": "needs 4 processes; the job has 2", "heads": "must divide the query heads"}[what]
    for r in res:
        assert r[what] is not None and msg in r[what], r[what]


# ---------------------------------------------------------------- 2 processes: data-parallel DPO and GAN


@pytest.fixture(scope="module")
def dp_run():
    from test_torch_gan import DISC, THC, disc_models, gan_batch, hift_models
    from test_torch_train_models import llm_batch, llm_models
    from torch_port_util import both

    JC, TC = both()
    _, _, tm = llm_models(JC.llm, TC.llm, seed=5)
    chosen, rejected = llm_batch(12, b=4), llm_batch(13, b=4)
    _, _, gen = hift_models(0)
    _, _, disc = disc_models(1)
    job = {"llm_cfg": TC.llm, "llm_sd": ranks._np(tm.state_dict()),
           "dpo_batch": {k: np.concatenate([chosen[k], rejected[k]]) for k in chosen},
           "hift_cfg": THC, "hift_sd": ranks._np(gen.state_dict()), "disc_kw": DISC,
           "disc_sd": ranks._np(disc.state_dict()), "gan_batch": gan_batch(7, b=4)}
    group = Group(ranks.dp_rank, 2, args=(job,), timeout=GROUP_TIMEOUT)
    one = ranks.dp_rank(0, 0, job)
    return group.join(), one


@pytest.mark.parametrize("run", ["dpo", "gan"])
def test_dp_steps_match_one_process(dp_run, run):
    res, one = dp_run
    for r in res:
        for k, v in one[run].items():
            np.testing.assert_allclose(r[run][k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        for k, v in one[f"{run}_params"].items():
            np.testing.assert_allclose(r[f"{run}_params"][k], v, rtol=2e-5, atol=2e-5, err_msg=k)


def test_dryrun_multichip():
    from fangyan_tts_torch.parallel import dryrun

    assert dryrun.main(["8", "--device", "cpu"]) == 0
