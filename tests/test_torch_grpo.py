"""The port's GRPO (fangyan_tts_torch/train/grpo.py, cli/grpo_train.py)
against the JAX package's (fangyan_tts_tpu/train/grpo.py), float32 on the
CPU, with the same weights (models/from_jax) and inputs:

- cer, and grpo_advantages with the population std (jnp.std's ddof 0; a
  zero-variance group gives 0), within 1e-6;
- sequence_logps on shared rollout tokens within 1e-4, 0 past each
  rollout's length;
- one make_grpo_step (the CLI's optimizer: clip_by_global_norm(1.0), then
  adamw) against a reference with weights of its own, old_logps off the
  policy's so that the ratio clips: loss, pg_loss, kl, reward_mean and the
  gradients' global norm within 2e-4 relative, each parameter's change
  within 1e-3 * lr of the JAX one where both packages' gradients agree to
  1e-3 of themselves (tests/test_torch_train_loop.py says why), the
  reference bit-equal after the step and the policy's requires_grad as it
  was before it;
- make_rollout_batch: the plans and tokens bit-equal, old_logps within 1e-4;
- generate_rollouts with top_k = 1 (no draw on either side): tokens and
  lengths bit-equal. Both packages decode in a bfloat16 cache, so greedy
  tokens can part at a near-tie of the top two logits; these weights and
  prompts meet none;
- grpo_iteration with the echo reward and a stub token2wav, from a frozen
  copy: the metrics within 2e-4 (the group's rewards are equal, so the
  advantages, the policy gradient and the KL are 0), and the parameters
  after it moved by adamw's weight decay alone, within 1e-3 * lr;
- ASRRewardClient against a stub http.server on 127.0.0.1 (port 0): the
  JAX package's client's scores;
- cli.grpo_train --device cpu for one step on a tiny model directory the
  test writes, with --reward_url on that stub server: metrics.jsonl and an
  llm_grpo_step1.msgpack that the JAX package's load_params reads, and the
  update runs after token2wav's inference-mode calls; without --device cpu
  and without a card it raises."""

import http.server
import io
import json
import threading
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fangyan_tts_torch.config as tcfg
from fangyan_tts_torch.cli import grpo_train as t_grpo_cli
from fangyan_tts_torch.config import config_to_json
from fangyan_tts_torch.data.lm_plan import build_prompt_plan, pad_plans_right
from fangyan_tts_torch.infer.tts import CosyVoice3TTS
from fangyan_tts_torch.models.from_jax import llm_from_jax, to_jax_tree
from fangyan_tts_torch.models.llm import CosyVoice3LM as TLM
from fangyan_tts_torch.train import checkpoint as tckpt
from fangyan_tts_torch.train import grpo as tgrpo
from fangyan_tts_torch.train import trainer as ttrainer
from fangyan_tts_torch.train.scheduler import global_norm, plain_adam
from fangyan_tts_tpu.data import lm_plan as jplan
from fangyan_tts_tpu.train import checkpoint as jckpt
from fangyan_tts_tpu.train import grpo as jgrpo
from fangyan_tts_tpu.train import trainer as jtrainer
from test_torch_train_models import llm_models
from torch_port_util import both, capture_grads, configs, to_jax

JC, TC = both()
LR = 5e-3
RTOL = 2e-4
REL_G = 1e-3
WD = 1e-4


def _close(got, want, rtol=RTOL, atol=0.0):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)) + atol, (float(got), float(want))


def _jax_tx():
    return optax.chain(capture_grads(), optax.clip_by_global_norm(1.0), optax.adamw(LR))


def test_cer():
    assert tgrpo.cer("你好世界", "你好世界") == 0.0
    assert tgrpo.cer("你好世界", "你坏世界") == 0.25
    assert tgrpo.cer("abc", "") == 1.0
    assert tgrpo.cer("今天天气", "今天气很好") == jgrpo.cer("今天天气", "今天气很好")


def test_grpo_advantages_population_std():
    r = np.asarray([1.0, 2.0, 3.0, 4.0, 10.0, 10.0, 10.0, 10.0, 0.5, -1.0, 2.5, 7.0], np.float32)
    got = tgrpo.grpo_advantages(torch.from_numpy(r), 4).numpy()
    np.testing.assert_allclose(got, np.asarray(jgrpo.grpo_advantages(jnp.asarray(r), 4)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[4:8], 0.0, atol=1e-6)  # a zero-variance group
    g = r[:4]
    assert got[0] == pytest.approx((g[0] - g.mean()) / g.std(ddof=0), rel=1e-6)
    assert got[0] != pytest.approx((g[0] - g.mean()) / g.std(ddof=1), rel=1e-3)


def _plans(cfg, lens=(3, 5), seed=0):
    rng = np.random.default_rng(seed)
    return [build_prompt_plan(cfg, rng.integers(0, 300, n).tolist(), []) for n in lens]


def _rollout_inputs(seed: int, group: int = 2, tr: int = 8):
    rng = np.random.default_rng(seed)
    plans = _plans(TC.llm, seed=seed)
    rep = [p for p in plans for _ in range(group)]
    b = pad_plans_right(rep, length=32)
    n = len(rep)
    tokens = rng.integers(0, 50, (n, tr)).astype(np.int32)
    lens = np.asarray([tr, 6, tr - 1, 5], np.int32)[:n]
    return plans, b, tokens, lens


def test_sequence_logps_and_grpo_step(monkeypatch):
    jm, p, tm = llm_models(JC.llm, TC.llm, seed=3)
    _, ref_p, ref = llm_models(JC.llm, TC.llm, seed=4)
    ref.requires_grad_(False)
    ref0 = {k: v.clone() for k, v in ref.state_dict().items()}
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    plans, b, tokens, lens = _rollout_inputs(5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = np.asarray(jgrpo.sequence_logps(jm, to_jax(p), jb["src"], jb["ids"], jb["lengths"], jb["lengths"],
                                           jnp.asarray(tokens), jnp.asarray(lens)))
    with torch.no_grad():
        got = tgrpo.sequence_logps(tm, tb["src"], tb["ids"], tb["lengths"], tb["lengths"], torch.from_numpy(tokens),
                                   torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[1, 6:].tolist() == [0.0, 0.0] and (got[1, :6] < 0).all()

    rng = np.random.default_rng(6)
    old = (want + rng.normal(0, 0.3, want.shape) * (np.arange(8)[None] < lens[:, None])).astype(np.float32)
    rewards = np.asarray([0.9, 0.1, 0.2, 0.7], np.float32)
    batch = {**b, "rollout_tokens": tokens, "rollout_lens": lens, "old_logps": old, "rewards": rewards}
    cfg = jgrpo.GRPOConfig(group_size=2, kl_coef=0.5)
    jtx = _jax_tx()
    jstate, jmet = jgrpo.make_grpo_step(jm, to_jax(ref_p), jtx, cfg)(
        jtrainer.init_state(to_jax(p), jtx), {k: jnp.asarray(v) for k, v in batch.items()})
    tm.requires_grad_(False)  # a serving module: the step switches gradients on for itself only
    ttx = plain_adam(LR, weight_decay=WD, grad_clip=1.0)
    tstate, tmet = tgrpo.make_grpo_step(tm, ref, ttx, tgrpo.GRPOConfig(group_size=2, kl_coef=0.5))(
        ttrainer.init_state(tm, ttx), batch)
    assert sorted(tmet) == sorted(jmet) and tstate.step == 1
    for k in jmet:
        _close(tmet[k], jmet[k])
    ratio = np.exp(want - old)[np.arange(8)[None] < lens[:, None]]
    assert ((ratio < 0.8) | (ratio > 1.2)).any() and abs(float(jmet["kl"])) > 1e-4  # the clip and the KL act
    assert all(not q.requires_grad for q in tm.parameters())
    assert all(torch.equal(v, ref0[k]) for k, v in ref.state_dict().items())

    # the port's gradients at the start (a fresh copy's step, its grads_of recorded), against the JAX step's own
    fresh = llm_models(JC.llm, TC.llm, seed=3)[2]
    grads = {}
    orig = tgrpo.grads_of
    monkeypatch.setattr(tgrpo, "grads_of", lambda m, loss: grads.update(zip(dict(m.named_parameters()), orig(m, loss)))
                        or list(grads.values()))
    tx0 = plain_adam(0.0)
    tgrpo.make_grpo_step(fresh, ref, tx0, tgrpo.GRPOConfig(group_size=2, kl_coef=0.5))(
        ttrainer.init_state(fresh, tx0), batch)
    jgrads = llm_from_jax(jax.device_get(jstate.opt_state[0]), TC.llm)
    _close(global_norm(list(grads.values())), global_norm(list(jgrads.values())))
    want_p = llm_from_jax(jax.device_get(jstate.params), TC.llm)
    for k, v in tm.named_parameters():
        skip = (grads[k] - jgrads[k]).abs() > REL_G * jgrads[k].abs()
        err = ((v.detach() - p0[k]) - (want_p[k] - p0[k])).abs()[~skip]
        assert skip.float().mean() < 0.5 and float(err.max()) <= 1e-3 * LR, (k, float(skip.float().mean()))


def test_make_rollout_batch_matches_jax():
    jm, p, tm = llm_models(JC.llm, TC.llm, seed=7)
    plans, _, tokens, lens = _rollout_inputs(8)
    tokens = np.pad(tokens, ((0, 0), (0, 56)))  # a decode's max_new columns; the batch keeps a multiple of 32
    rewards = np.asarray([1.0, 0.0, 0.5, 0.25], np.float32)
    jplans = [jplan.Plan(src=q.src, ids=q.ids, targets=q.targets) for q in plans]
    want = jgrpo.make_rollout_batch(jm, to_jax(p), jplans, 2, tokens, lens, rewards)
    got = tgrpo.make_rollout_batch(tm, plans, 2, tokens, lens, rewards)
    assert sorted(got) == sorted(want) and got["rollout_tokens"].shape == (4, 32)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if k == "old_logps":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_generate_rollouts_greedy_match_jax():
    """top_k = 1: neither side draws (see the module docstring on near-ties)."""
    jm, p, tm = llm_models(JC.llm, TC.llm, seed=11)
    plans = _plans(TC.llm, lens=(2, 3), seed=12)
    jplans = [jplan.Plan(src=q.src, ids=q.ids, targets=q.targets) for q in plans]
    want_tok, want_len = jgrpo.generate_rollouts(jm, to_jax(p), jplans, 2, jax.random.PRNGKey(0))
    got_tok, got_len = tgrpo.generate_rollouts(tm, plans, 2, torch.Generator().manual_seed(0))
    bk = tgrpo.rollout_buckets(plans, 2)
    assert got_tok.shape == (4, bk["max_new"]) and bk["cache_len"] % 128 == 0 and bk["tp"] == 32
    np.testing.assert_array_equal(got_len, np.asarray(want_len))
    np.testing.assert_array_equal(got_tok, np.asarray(want_tok))
    assert (got_len >= bk["min_lens"]).all() and (got_len <= bk["max_lens"]).all() and got_len.max() > 0


def _stub_wav(tokens: np.ndarray) -> np.ndarray:
    return np.tile(np.asarray(tokens, np.float32) / 100.0, 480)


def test_grpo_iteration_echo_reward_matches_jax():
    jm, p, tm = llm_models(JC.llm, TC.llm, seed=13)
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    plans = _plans(TC.llm, lens=(2, 3), seed=14)
    jplans = [jplan.Plan(src=q.src, ids=q.ids, targets=q.targets) for q in plans]
    texts = ["你好", "早上好"]
    cfg = jgrpo.GRPOConfig(group_size=2)
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    jstate = jtrainer.init_state(to_jax(p), jtx)
    jstate, jmet = jgrpo.grpo_iteration(jm, jstate, jgrpo.make_grpo_step(jm, to_jax(p), jtx, cfg), jplans, texts,
                                        t_grpo_cli.reward_echo, _stub_wav, 2, jax.random.PRNGKey(0))
    ttx = plain_adam(LR, weight_decay=WD, grad_clip=1.0)
    step = tgrpo.make_grpo_step(tm, ttrainer.frozen_copy(tm), ttx, tgrpo.GRPOConfig(group_size=2))
    tstate, tmet = tgrpo.grpo_iteration(tm, ttrainer.init_state(tm, ttx), step, plans, texts, t_grpo_cli.reward_echo,
                                        _stub_wav, 2, torch.Generator().manual_seed(0))
    assert sorted(tmet) == sorted(jmet) and tstate.step == int(jstate.step) == 1
    assert tmet["reward_mean"] == jmet["reward_mean"] == -1.0
    for k in jmet:
        _close(tmet[k], jmet[k], atol=1e-7)
    # equal rewards: the advantages are 0, and the policy is its frozen copy: the KL's gradient is 0 too. The
    # port's gradients are exactly 0 and adamw's step is its weight decay alone; the JAX step's are rounding
    # noise of its two forwards, which Adam scales up to whole steps of lr, so its parameters are not held
    for k, v in tm.state_dict().items():
        assert float((v - p0[k] * (1 - LR * WD)).abs().max()) <= 1e-3 * LR, k


class _StubASR(http.server.BaseHTTPRequestHandler):
    """Answers a posted wav with a transcript of (frames // 480) % 4 characters."""

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        with wave.open(io.BytesIO(body), "rb") as w:
            assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 24000)
            n = w.getnframes()
        out = json.dumps({"text": "你好世界"[: (n // 480) % 4 + 1]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *args):
        pass


@pytest.fixture()
def asr_server():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _StubASR)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_asr_reward_client_matches_jax(asr_server):
    rng = np.random.default_rng(15)
    wavs = [rng.uniform(-1.2, 1.2, n).astype(np.float32) for n in (480, 960, 1440, 2400)]
    texts = ["你好世界", "你好", "世界", "你"]
    got = tgrpo.ASRRewardClient(asr_server + "/asr")(wavs, texts)
    want = jgrpo.ASRRewardClient(asr_server + "/asr")(wavs, texts)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and len(set(got.tolist())) > 1


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny CosyVoice3 directory in the JAX package's layout (config.json
    and the three msgpack checkpoints), random weights, sampling decode."""
    d = tmp_path_factory.mktemp("grpo_model")
    cfg = configs(tcfg, greedy=False)
    tts = CosyVoice3TTS.random_init(cfg, dtype=torch.float32, device="cpu", seed=16)
    (d / "config.json").write_text(config_to_json(cfg))
    for name in ("llm", "flow", "hift"):
        module = getattr(tts, name)
        tckpt.save_params(d / f"{name}.msgpack", to_jax_tree(module.state_dict(), module))
    return d


def test_grpo_train_cli(model_dir, tmp_path, asr_server):
    data = tmp_path / "train.jsonl"
    data.write_text("".join(json.dumps({"text": t}, ensure_ascii=False) + "\n" for t in ("你好", "早上好", "谢谢")))
    out = tmp_path / "grpo"
    t_grpo_cli.main(["--model_dir", str(model_dir), "--data", str(data), "--out_dir", str(out), "--steps", "1",
                     "--prompts_per_step", "2", "--group_size", "2", "--lr", "1e-2", "--reward_url", asr_server,
                     "--device", "cpu"])
    records = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 1 and {"loss", "pg_loss", "kl", "reward_mean", "step", "wall_s"} <= set(records[0])
    assert all(np.isfinite(v) for v in records[0].values()) and -1.0 <= records[0]["reward_mean"] <= 0.0
    tree = jckpt.load_params(out / "llm_grpo_step1.msgpack")
    cfg = configs(tcfg, greedy=False)
    lm = TLM(cfg.llm)
    lm.load_state_dict(llm_from_jax(tree, cfg.llm), strict=True)
    assert all(torch.isfinite(v.float()).all() for v in lm.state_dict().values())


def test_grpo_train_cli_needs_a_card(model_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "d.jsonl").write_text(json.dumps({"text": "你好"}) + "\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_grpo_cli.main(["--model_dir", str(model_dir), "--data", str(tmp_path / "d.jsonl"), "--out_dir",
                         str(tmp_path / "o")])
