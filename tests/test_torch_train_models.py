"""The port's training forwards against the JAX package, float32 on the CPU,
with the same weights (models/from_jax carries the JAX trees in, and the
JAX gradients through the same mapping):

- `CosyVoice3LM.forward` / `label_smoothed_ce` against the JAX module's
  `__call__` on right-padded plans (IGNORE_ID targets in every row), label
  smoothing 0 and 0.1, length-normalized loss on and off;
- `CausalMaskedDiffWithDiT.forward` against the JAX loss with the JAX
  package's own five draws (jax.random.split(key, 5) and the calls of
  fangyan_tts_tpu/models/flow.py:227-253) fed to the port, streaming off and
  on, ragged rows;
- QwenConfig.remat "full" and "dots" against no remat in the port, and remat
  leaving the decode and the prefill bit-equal.

Tolerances: loss within 2e-4 relative, acc equal; each gradient leaf within
1e-4 * max |g_jax| + 1e-7 (max abs difference); remat gradients within
1e-6 * max |g| + 1e-9 of no remat (the same operations, recomputed)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.models import flow as tflow
from fangyan_tts_torch.models import llm as tllm
from fangyan_tts_torch.models import qwen2 as tq
from fangyan_tts_torch.models.from_jax import flow_from_jax, llm_from_jax
from fangyan_tts_torch.ops.device import refuse_grad
from fangyan_tts_tpu.data.lm_plan import build_plan, pad_plans_right
from fangyan_tts_tpu.models import flow as jflow
from fangyan_tts_tpu.models.llm import CosyVoice3LM
from torch_port_util import both, np_params, to_jax

JC, TC = both()
LOSS_RTOL = 2e-4


def assert_grads(got: dict, want: dict, rel: float = 1e-4, eps: float = 1e-7):
    """Per leaf: max |got - want| <= rel * max |want| + eps."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.float()
        err = float((got[k].float() - w).abs().max())
        assert err <= rel * float(w.abs().max()) + eps, (k, err, float(w.abs().max()))


def llm_models(jcfg, tcfg, seed: int = 0, gain: float = 0.5):
    jm = CosyVoice3LM(jcfg, dtype=jnp.float32)
    t = jnp.zeros((1, 8), jnp.int32)
    p = np_params(jm, seed, t, t, jnp.asarray([8]), t, gain=gain)
    tm = tllm.CosyVoice3LM(tcfg, dtype=torch.float32)
    tm.load_state_dict(llm_from_jax(p, tcfg), strict=True)
    return jm, p, tm


def llm_batch(seed: int, b: int = 3, length: int = 48) -> dict:
    """Right-padded plans of b rows (every other one bistream), numpy."""
    rng = np.random.default_rng(seed)
    plans = [build_plan(JC.llm, rng.integers(0, 300, int(rng.integers(3, 8))).tolist(),
                        rng.integers(0, 50, int(rng.integers(6, 20))).tolist(), bistream=(i % 2 == 0))
             for i in range(b)]
    return {k: np.asarray(v) for k, v in pad_plans_right(plans, length).items()}


def with_hits(tm, batch: dict, every: int = 3) -> dict:
    """`batch` with every `every`-th valid target set to the model's own
    argmax there, so that acc is neither 0 nor 1."""
    src, ids, lengths, _ = torch_batch(batch)
    with torch.no_grad():
        t = ids.shape[1]
        x = tm.embed_plan(src, ids)
        pos = torch.arange(t, dtype=torch.int32).expand(ids.shape[0], t)
        pred = tm.decode_logits(tm.llm(x, pos, tq.prefill_attn_bias(t, lengths))).argmax(-1).numpy()
    targets = batch["targets"].copy()
    rows, cols = np.nonzero(targets != tllm.IGNORE_ID)
    targets[rows[::every], cols[::every]] = pred[rows[::every], cols[::every]]
    return dict(batch, targets=targets)


def jax_llm_loss(jm, p, batch):
    def f(params):
        return jm.apply({"params": params}, *(jnp.asarray(batch[k]) for k in ("src", "ids", "lengths", "targets")))

    (loss, acc), g = jax.value_and_grad(f, has_aux=True)(to_jax(p))
    return float(loss), float(acc), g


def torch_batch(batch: dict) -> list:
    return [torch.from_numpy(batch[k]) for k in ("src", "ids", "lengths", "targets")]


@pytest.mark.parametrize("lsm, norm", [(0.0, True), (0.1, True), (0.0, False), (0.1, False)])
def test_llm_loss_and_grads(lsm, norm):
    jcfg = replace(JC.llm, lsm_weight=lsm, length_normalized_loss=norm)
    tcfg = replace(TC.llm, lsm_weight=lsm, length_normalized_loss=norm)
    jm, p, tm = llm_models(jcfg, tcfg)
    batch = with_hits(tm, llm_batch(1))
    assert (batch["lengths"] < batch["src"].shape[1]).all() and (batch["targets"] == -1).any(axis=1).all()
    want_loss, want_acc, jg = jax_llm_loss(jm, p, batch)
    loss, acc = tm(*torch_batch(batch))
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert 0.0 < want_acc < 1.0 and float(acc) == pytest.approx(want_acc, abs=1e-7)
    assert_grads(dict(zip(dict(tm.named_parameters()), grads)), llm_from_jax(jax.device_get(jg), tcfg))


def test_label_smoothed_ce_ignores_and_normalizes():
    """Only non-IGNORE_ID targets count; an all-ignored batch gives loss 0
    and acc 0 (its denominators are clamped at 1), as in the JAX package."""
    logits = torch.randn(2, 5, 7)
    targets = torch.full((2, 5), tllm.IGNORE_ID)
    loss, acc = tllm.label_smoothed_ce(logits, targets, 0.1, True)
    assert float(loss) == 0.0 and float(acc) == 0.0
    targets[0, :2] = logits[0, :2].argmax(-1)
    loss, acc = tllm.label_smoothed_ce(logits, targets, 0.0, True)
    want = -torch.log_softmax(logits[0, :2], -1).gather(-1, targets[0, :2, None]).mean()
    assert float(acc) == 1.0 and float(loss) == pytest.approx(float(want), rel=1e-6)


def flow_models(seed: int = 0):
    jm = jflow.CausalMaskedDiffWithDiT(JC.flow)
    t = jnp.zeros((1, 8), jnp.int32)
    p = np_params(jm, seed, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)), jnp.asarray([16]),
                  jnp.zeros((1, 192)), jax.random.PRNGKey(0))
    tm = tflow.CausalMaskedDiffWithDiT(TC.flow)
    tm.load_state_dict(flow_from_jax(p, TC.flow), strict=True)
    return jm, p, tm


def flow_batch(seed: int, token_len=(12, 9, 6)) -> dict:
    rng = np.random.default_rng(seed)
    b, lt = len(token_len), max(token_len)
    feat_len = np.asarray(token_len, np.int32) * 2
    feat = rng.standard_normal((b, 2 * lt, 80)).astype(np.float32)
    feat *= (np.arange(2 * lt)[None, :, None] < feat_len[:, None, None])
    return {"token": rng.integers(0, 50, (b, lt)).astype(np.int32), "token_len": np.asarray(token_len, np.int32),
            "feat": feat.astype(np.float32), "feat_len": feat_len,
            "embedding": rng.standard_normal((b, 192)).astype(np.float32)}


def jax_draws(key, b: int, feat_shape) -> dict:
    """The JAX loss's five draws from `key` (fangyan_tts_tpu/models/flow.py:
    227-253), as the port's draws (torch tensors)."""
    k_t, k_z, k_cfg, k_cond, k_condlen = jax.random.split(key, 5)
    d = {"use_cond": jax.random.bernoulli(k_cond, 0.5, (b,)), "cond_len": jax.random.uniform(k_condlen, (b,)),
         "t": jax.random.uniform(k_t, (b, 1, 1), jnp.float32), "z": jax.random.normal(k_z, feat_shape, jnp.float32),
         "cfg": jax.random.uniform(k_cfg, (b,))}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


FLOW_KEYS = ("token", "token_len", "feat", "feat_len", "embedding")


@pytest.mark.parametrize("streaming", [False, True])
def test_flow_loss_and_grads(streaming):
    jm, p, tm = flow_models(1)
    batch = flow_batch(2)
    key = jax.random.PRNGKey(5)
    draws = jax_draws(key, 3, batch["feat"].shape)
    # the key exercises both conditioning branches and keeps the CFG condition on some rows
    assert draws["use_cond"].any() and not draws["use_cond"].all()
    assert (draws["cfg"] > JC.flow.training_cfg_rate).any()

    def f(params):
        loss, _ = jm.apply({"params": params}, *(jnp.asarray(batch[k]) for k in FLOW_KEYS), key,
                           streaming=streaming)
        return loss

    want, jg = jax.value_and_grad(f)(to_jax(p))
    loss, aux = tm(*(torch.from_numpy(batch[k]) for k in FLOW_KEYS), draws, streaming=streaming)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    assert aux["loss_cfm"] is loss
    assert_grads(dict(zip(dict(tm.named_parameters()), grads)), flow_from_jax(jax.device_get(jg), TC.flow))


def test_flow_train_draws():
    """Shapes, dtypes and ranges of the draws; one generator seed gives the
    same draws."""
    gen = torch.Generator().manual_seed(3)
    d = tflow.flow_train_draws(4, (4, 10, 80), "cpu", gen)
    assert d["t"].shape == (4, 1, 1) and d["z"].shape == (4, 10, 80) and d["use_cond"].dtype == torch.bool
    assert all(float(d[k].min()) >= 0.0 and float(d[k].max()) < 1.0 for k in ("t", "cfg", "cond_len"))
    again = tflow.flow_train_draws(4, (4, 10, 80), "cpu", torch.Generator().manual_seed(3))
    assert all(torch.equal(d[k], again[k]) for k in d)


def _remat_cfg(mode: str):
    return replace(TC.llm, qwen=replace(TC.llm.qwen, remat=mode))


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_grads_match_no_remat(mode):
    """remat changes what autograd keeps, not the numbers: the same loss and
    gradients as without it."""
    _, p, base = llm_models(JC.llm, TC.llm, seed=3)
    rm = tllm.CosyVoice3LM(_remat_cfg(mode), dtype=torch.float32)
    rm.load_state_dict(base.state_dict(), strict=True)
    batch = torch_batch(llm_batch(4))
    l0, _ = base(*batch)
    g0 = torch.autograd.grad(l0, list(base.parameters()))
    l1, _ = rm(*batch)
    g1 = torch.autograd.grad(l1, list(rm.parameters()))
    assert float(l1) == pytest.approx(float(l0), rel=1e-6)
    names = list(dict(base.named_parameters()))
    assert_grads(dict(zip(names, g1)), dict(zip(names, g0)), rel=1e-6, eps=1e-9)


def test_remat_leaves_decode_and_prefill_bit_equal():
    """The cached paths ignore remat: prefill hidden states and decode logits
    are bit-equal with remat "full" and without."""
    _, _, base = llm_models(JC.llm, TC.llm, seed=5)
    rm = tllm.CosyVoice3LM(_remat_cfg("full"), dtype=torch.float32)
    rm.load_state_dict(base.state_dict(), strict=True)
    rng = np.random.default_rng(6)
    src = torch.from_numpy(rng.integers(0, 2, (2, 12)).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, 50, (2, 12)).astype(np.int32))
    lengths = torch.tensor([12, 7], dtype=torch.int32)
    outs = []
    for m in (base, rm):
        with torch.no_grad():
            cache = tq.init_cache(m.cfg.qwen, 2, 32, dtype=torch.float32)
            h = m.prefill_leftpad(src, ids, lengths, cache)
            tok = torch.tensor([3, 9])
            logits = m.decode_step(tok, torch.tensor([[12], [7]], dtype=torch.int32),
                                   (12 - lengths).to(torch.int32), 13, cache)
        outs.append((h, logits, cache["k"].clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_prefill_attn_bias_matches_jax():
    from fangyan_tts_tpu.models import qwen2 as jq

    lengths = np.asarray([5, 3, 0], np.int32)
    got = tq.prefill_attn_bias(5, torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.prefill_attn_bias(5, jnp.asarray(lengths))))
    np.testing.assert_array_equal(tq.causal_attn_bias(4).numpy(), np.asarray(jq.causal_attn_bias(4)))


def test_refuse_grad():
    """The kernel wrappers' guard: an input that requires grad raises while
    autograd records, and passes under no_grad or without grad."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("k", "the dense route", torch.zeros(2), x)
    with torch.no_grad():
        refuse_grad("k", "the dense route", x)
    refuse_grad("k", "the dense route", torch.zeros(2))
