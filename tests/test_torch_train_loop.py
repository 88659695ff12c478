"""The port's training loop (fangyan_tts_torch/train/{trainer,executor,
checkpoint}.py and cli/{train,average_model}.py) against the JAX package's,
float32 on the CPU, with the same weights and batches:

- two LLM train steps at accum 1 and 2 (stacked microbatches), and two flow
  steps with the JAX package's draws fed to the port, against
  trainer.make_*_train_step: loss and grad_norm within 2e-4 relative, each
  parameter's change from the start within 1e-3 * lr of the JAX one (acc
  equal), at every element (over half of each tensor) where the two
  packages' gradients of both steps agree to 1e-3 of themselves: Adam
  divides each gradient by its own size, so elsewhere the gradient limit of
  test_torch_train_models does not hold a step to 1e-3 * lr (the key
  projections' biases, whose gradient is zero in exact arithmetic and
  rounding noise in float32, are such elements);
- in-step accumulation equal to the optimizer's MultiSteps over the same
  microbatches (as tests/test_train_accum.py holds for JAX);
- checkpoints written by either package read by the other: load_meta,
  select_val_best and average_checkpoints agree (the averages bit-equal);
- one Executor epoch writes the JAX executor's checkpoint names, sidecar
  keys and metrics.jsonl tags;
- the train CLI on a tiny corpus (torch_port_util.write_corpus, the port's
  prepare_corpus with stub models) for the llm and the flow, one epoch on
  the CPU: its checkpoints load in the JAX package's load_params and give
  the port's loss there within 2e-4; average_model averages the two
  val-best ones as the JAX package does."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.cli import average_model as t_average_cli
from fangyan_tts_torch.cli import train as t_train_cli
from fangyan_tts_torch.config import config_to_json
from fangyan_tts_torch.data.dataset import stack_microbatches
from fangyan_tts_torch.data.extract import prepare_corpus
from fangyan_tts_torch.models import flow as tflow
from fangyan_tts_torch.models import llm as tllm
from fangyan_tts_torch.models.from_jax import flow_from_jax, llm_from_jax
from fangyan_tts_torch.train import checkpoint as tckpt
from fangyan_tts_torch.train import executor as texec
from fangyan_tts_torch.train import scheduler as tsched
from fangyan_tts_torch.train import trainer as ttrainer
from fangyan_tts_tpu.models import flow as jflow
from fangyan_tts_tpu.models.llm import CosyVoice3LM
from fangyan_tts_tpu.train import checkpoint as jckpt
from fangyan_tts_tpu.train import executor as jexec
from fangyan_tts_tpu.train import scheduler as jsched
from fangyan_tts_tpu.train import trainer as jtrainer
from test_torch_train_models import (FLOW_KEYS, flow_batch, flow_models, jax_draws, llm_batch, llm_models,
                                     torch_batch)
from torch_port_util import both, to_jax, write_corpus

JC, TC = both()
LR = 5e-3
RTOL = 2e-4
REL_G = 1e-3  # see _undetermined


def _close(got, want, rtol=RTOL):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(got), float(want))


def _undetermined(tm, port_loss, jm, jparams, batches: list, from_jax, cfg, *extra) -> dict:
    """Per parameter, True where the two packages' gradients of this step
    (the mean over the microbatches, at the current parameters) differ by
    more than REL_G of the JAX one. Adam divides each gradient by its own
    running size, so a step moves by about lr * |dg| / |g| when the gradient
    moves by dg: where the gradients agree to REL_G of themselves, the steps
    agree to about REL_G * lr, and elsewhere (gradients that are
    rounding noise, as the key projections' biases', zero in exact
    arithmetic since the softmax removes a shift shared by every key) the
    gradient limit of test_torch_train_models does not hold the step.
    port_loss(i) is the port's loss on microbatch i; `extra` (one per
    microbatch) follow the JAX batch."""
    def loss(p, b, *e):
        return jm.apply({"params": p}, *b, *e)[0]

    jg, tg = None, None
    for i, b in enumerate(batches):
        g = jax.grad(loss)(jparams, [jnp.asarray(x) for x in b], *(e[i] for e in extra))
        jg = g if jg is None else jax.tree.map(jnp.add, jg, g)
        t = torch.autograd.grad(port_loss(i), list(tm.parameters()))
        tg = t if tg is None else [a + c for a, c in zip(tg, t)]
    jg = from_jax(jax.device_get(jax.tree.map(lambda x: x / len(batches), jg)), cfg)
    names = [k for k, _ in tm.named_parameters()]
    return {k: (t / len(batches) - jg[k]).abs() > REL_G * jg[k].abs() for k, t in zip(names, tg)}


def _assert_moved_alike(tm, p0: dict, jparams, from_jax, cfg, skip: dict):
    """Each parameter's change from p0 within 1e-3 * LR of the JAX one, but
    where `skip` (the steps' _undetermined elements) is set."""
    want = from_jax(jax.device_get(jparams), cfg)
    for k, v in tm.state_dict().items():
        err = ((v - p0[k]) - (want[k] - p0[k])).abs()[~skip[k]]
        assert skip[k].float().mean() < 0.5 and float(err.max()) <= 1e-3 * LR, (k, float(skip[k].float().mean()))


def _tx(accum_grad: int = 1):
    kw = dict(lr=LR, scheduler="constantlr", accum_grad=accum_grad)
    return jsched.build_optimizer(**kw), tsched.build_optimizer(**kw)


@pytest.mark.parametrize("accum", [1, 2])
def test_llm_steps_match_jax(accum):
    jm, p, tm = llm_models(JC.llm, TC.llm, seed=7)
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    jtx, ttx = _tx()
    jstep, tstep = jtrainer.make_llm_train_step(jm, jtx, accum=accum), ttrainer.make_llm_train_step(tm, ttx, accum=accum)
    jstate, tstate = jtrainer.init_state(to_jax(p), jtx), ttrainer.init_state(tm, ttx)
    skip = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in p0.items()}
    for i in range(2):
        mbs = [llm_batch(10 * i + j) for j in range(accum)]
        batch = mbs[0] if accum == 1 else next(stack_microbatches(iter(mbs), accum))
        micro = [[batch[k] if accum == 1 else batch[k][j] for k in ("src", "ids", "lengths", "targets")]
                 for j in range(accum)]
        port_loss = lambda j: tm(*(torch.from_numpy(x) for x in micro[j]))[0]
        for k, m in _undetermined(tm, port_loss, jm, jstate.params, micro, llm_from_jax, TC.llm).items():
            skip[k] |= m
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        tstate, tm_ = tstep(tstate, batch)
        _close(tm_["loss"], jm_["loss"])
        _close(tm_["grad_norm"], jm_["grad_norm"])
        assert float(tm_["acc"]) == pytest.approx(float(jm_["acc"]), abs=1e-7)
    assert tstate.step == int(jstate.step) == 2
    _assert_moved_alike(tm, p0, jstate.params, llm_from_jax, TC.llm, skip)


@pytest.mark.parametrize("accum", [1, 2])
def test_flow_steps_match_jax(accum):
    jm, p, tm = flow_models(3)
    p0 = {k: v.clone() for k, v in tm.state_dict().items()}
    jtx, ttx = _tx()
    jstep = jtrainer.make_flow_train_step(jm, jtx, accum=accum)
    tstep = ttrainer.make_flow_train_step(tm, ttx, accum=accum)
    jstate, tstate = jtrainer.init_state(to_jax(p), jtx), ttrainer.init_state(tm, ttx)
    skip = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in p0.items()}
    for i in range(2):
        mbs = [flow_batch(10 * i + j) for j in range(accum)]
        key = jax.random.PRNGKey(20 + i)
        shape = mbs[0]["feat"].shape
        keys = [key] if accum == 1 else list(jax.random.split(key, accum))
        if accum == 1:
            batch, draws = mbs[0], jax_draws(key, shape[0], shape)
        else:
            batch = {k: np.stack([mb[k] for mb in mbs]) for k in FLOW_KEYS}
            draws = [jax_draws(r, shape[0], shape) for r in keys]
        micro = [[mb[k] for k in FLOW_KEYS] for mb in mbs]
        port_loss = lambda j: tm(*(torch.from_numpy(x) for x in micro[j]), draws if accum == 1 else draws[j])[0]
        for k, m in _undetermined(tm, port_loss, jm, jstate.params, micro, flow_from_jax, TC.flow, keys).items():
            skip[k] |= m
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tstate, tm_ = tstep(tstate, batch, draws)
        assert sorted(tm_) == sorted(jm_)
        _close(tm_["loss"], jm_["loss"])
        _close(tm_["grad_norm"], jm_["grad_norm"])
    _assert_moved_alike(tm, p0, jstate.params, flow_from_jax, TC.flow, skip)


def test_in_step_accum_matches_multisteps():
    _, _, tm = llm_models(JC.llm, TC.llm, seed=8)
    tm2 = tllm.CosyVoice3LM(TC.llm, dtype=torch.float32)
    tm2.load_state_dict(tm.state_dict())
    mbs = [llm_batch(30), llm_batch(31)]
    ms_tx = tsched.build_optimizer(lr=LR, scheduler="constantlr", accum_grad=2)
    step = ttrainer.make_llm_train_step(tm, ms_tx)
    state = ttrainer.init_state(tm, ms_tx)
    for mb in mbs:
        state, _ = step(state, mb)
    tx = tsched.build_optimizer(lr=LR, scheduler="constantlr")
    state2, m = ttrainer.make_llm_train_step(tm2, tx, accum=2)(ttrainer.init_state(tm2, tx),
                                                               next(stack_microbatches(iter(mbs), 2)))
    for (k, a), b in zip(tm.state_dict().items(), tm2.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5, atol=2e-6, err_msg=k)
    assert np.isfinite(float(m["loss"])) and state.opt_state.gradient_step == 1


def test_mesh_raises():
    """A mesh that is not the port's, or one the module was not sharded on,
    raises (tests/test_torch_parallel.py runs the sharded steps)."""
    from fangyan_tts_torch.parallel.mesh import Mesh

    _, _, tm = llm_models(JC.llm, TC.llm)
    with pytest.raises(TypeError, match="parallel"):
        ttrainer.make_llm_train_step(tm, tsched.build_optimizer(), mesh=object())
    with pytest.raises(ValueError, match="not sharded on this mesh"):
        ttrainer.make_llm_train_step(tm, tsched.build_optimizer(), mesh=Mesh(dp=2))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_read(tmp_path, writer):
    rng = np.random.default_rng(3)
    trees = [{"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)}, "b": rng.standard_normal(5).astype(np.float32)}
             for _ in range(3)]
    save = (jckpt if writer == "jax" else tckpt).save_params
    for i, (tree, cv) in enumerate(zip(trees, (2.0, 1.0, 1.5))):
        save(tmp_path / f"epoch_{i}_whole.msgpack", tree, meta={"epoch": i, "step": 10 * i, "cv_loss": cv})
    save(tmp_path / "init.msgpack", trees[0], meta={"epoch": -1, "step": 0})
    for mod in (jckpt, tckpt):
        assert mod.load_meta(tmp_path / "epoch_1_whole.msgpack") == {"epoch": 1, "step": 10, "cv_loss": 1.0}
        assert mod.load_meta(tmp_path / "missing.msgpack") is None
    best = tckpt.select_val_best(tmp_path, 2)
    assert best == jckpt.select_val_best(tmp_path, 2) and [Path(b).name for b in best] == \
        ["epoch_1_whole.msgpack", "epoch_2_whole.msgpack"]
    got, want = tckpt.average_checkpoints(best), jckpt.average_checkpoints(best)
    np.testing.assert_array_equal(got["a"]["w"], want["a"]["w"])
    np.testing.assert_array_equal(got["b"], want["b"])


def _records(path: Path) -> list:
    return [(r["tag"], r["step"], sorted(r)) for r in map(json.loads, path.read_text().splitlines())]


def test_executor_epoch_writes_what_jax_writes(tmp_path):
    jm, p, tm = llm_models(JC.llm, TC.llm, seed=9)
    jtx, ttx = _tx()
    batches = [llm_batch(40 + i) for i in range(3)]
    cv = [llm_batch(50), llm_batch(51, b=2)]
    jex = jexec.Executor(jtrainer.make_llm_train_step(jm, jtx), tmp_path / "jax", log_interval=1, save_per_step=2)
    tex = texec.Executor(ttrainer.make_llm_train_step(tm, ttx), tmp_path / "torch", log_interval=1, save_per_step=2)

    def jcv(params, b):
        loss, acc = jm.apply({"params": params}, *(b[k] for k in ("src", "ids", "lengths", "targets")))
        return {"loss": loss, "acc": acc}

    jex.train_one_epoch(jtrainer.init_state(to_jax(p), jtx), [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                        0, jax.random.PRNGKey(0), [{k: jnp.asarray(v) for k, v in b.items()} for b in cv], jcv)
    tstate, _ = tex.train_one_epoch(ttrainer.init_state(tm, ttx), batches, 0, None, cv,
                                    lambda m, b: dict(zip(("loss", "acc"), m(*torch_batch(b)))))
    names = sorted(f.name for f in (tmp_path / "torch").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert names == ["epoch_0_whole.msgpack", "epoch_0_whole.msgpack.json", "metrics.jsonl", "step_2.msgpack",
                     "step_2.msgpack.json"]
    for n in ("step_2.msgpack", "epoch_0_whole.msgpack"):
        jmeta, tmeta = jckpt.load_meta(tmp_path / "jax" / n), tckpt.load_meta(tmp_path / "torch" / n)
        assert sorted(tmeta) == sorted(jmeta) and tmeta["step"] == jmeta["step"]
        _close(tmeta["cv_loss"], jmeta["cv_loss"])
    assert _records(tmp_path / "torch" / "metrics.jsonl") == _records(tmp_path / "jax" / "metrics.jsonl")
    # the port's checkpoint is the JAX tree of its parameters
    tree = jckpt.load_params(tmp_path / "torch" / "epoch_0_whole.msgpack")
    for k, v in llm_from_jax(tree, TC.llm).items():
        assert torch.equal(v, tstate.params.state_dict()[k]), k


def _stub_models():
    """CAM++ and S3 stand-ins for prepare_corpus: an x-vector from the fbank's
    mean and 25 Hz codes below the tiny LLM's 50 speech tokens."""

    def emb(feats, frame_len):
        return feats.mean(dim=1).repeat(1, 3)[:, :192]

    def tok(mel, mel_len):
        n = mel.shape[2] // 4
        codes = (mel[:, :, : 4 * n].reshape(mel.shape[0], -1, n, 4).mean(dim=(1, 3)) * 7).long() % 50
        return codes.to(torch.int32), (mel_len // 4).to(torch.int32)

    return emb, tok


@pytest.fixture(scope="module")
def corpus_lists(tmp_path_factory):
    """A tiny corpus through the port's prepare_corpus: 8 utterances of 1-1.9
    s, 2 speakers, 4 a shard; shard 0 is the train list, shard 1 the CV list;
    and the tiny configuration as json."""
    root = tmp_path_factory.mktemp("train_corpus")
    write_corpus(root, [16000 + 1900 * i for i in range(8)], seed=11, spk_size=4)
    shards = prepare_corpus(root, root / "pq", *_stub_models(), batch_size=4, num_utts_per_parquet=4,
                            instruct=True, device="cpu")
    (root / "train.list").write_text(shards[0] + "\n")
    (root / "cv.list").write_text(shards[1] + "\n")
    (root / "conf.json").write_text(config_to_json(TC))
    return root


def _train(root: Path, model: str, out: Path, *extra: str) -> None:
    t_train_cli.main(["--model", model, "--train_data", str(root / "train.list"), "--cv_data", str(root / "cv.list"),
                      "--model_dir", str(out), "--config", str(root / "conf.json"), "--device", "cpu",
                      "--max_epoch", "1", "--lr", "1e-3", "--max_frames_in_batch", "100", "--save_per_step", "1",
                      "--log_interval", "1", *extra])


def _assert_run(out: Path) -> None:
    names = sorted(f.name for f in out.iterdir())
    assert names == ["epoch_0_whole.msgpack", "epoch_0_whole.msgpack.json", "init.msgpack", "init.msgpack.json",
                     "metrics.jsonl", "step_1.msgpack", "step_1.msgpack.json", "step_2.msgpack",
                     "step_2.msgpack.json"], names
    assert tckpt.load_meta(out / "init.msgpack") == {"epoch": -1, "step": 0}
    for n in ("step_1", "step_2", "epoch_0_whole"):
        meta = tckpt.load_meta(out / f"{n}.msgpack")
        assert np.isfinite(meta["cv_loss"]) and meta["epoch"] == 0, (n, meta)
    tags = [r[0] for r in _records(out / "metrics.jsonl")]
    assert tags == ["train", "cv", "train", "cv", "cv"]


def test_train_cli_llm(corpus_lists, tmp_path):
    out = tmp_path / "llm"
    _train(corpus_lists, "llm", out)
    _assert_run(out)
    # the checkpoint in the JAX package: its loss there equals the port's on the same weights
    tree = jckpt.load_params(out / "epoch_0_whole.msgpack")
    tm = tllm.CosyVoice3LM(TC.llm, dtype=torch.float32)
    tm.load_state_dict(llm_from_jax(tckpt.load_params(out / "epoch_0_whole.msgpack"), TC.llm))
    batch = llm_batch(60)
    want, _ = CosyVoice3LM(JC.llm).apply({"params": to_jax(tree)}, *(jnp.asarray(batch[k]) for k in
                                                                      ("src", "ids", "lengths", "targets")))
    with torch.no_grad():
        got, _ = tm(*torch_batch(batch))
    _close(got, want)
    init = llm_from_jax(tckpt.load_params(out / "init.msgpack"), TC.llm)
    assert any(not torch.equal(init[k], v) for k, v in tm.state_dict().items())  # it trained

    avg = tmp_path / "avg.msgpack"
    t_average_cli.main(["--dst_model", str(avg), "--src_path", str(out), "--num", "2", "--val_best"])
    best = jckpt.select_val_best(out, 2)
    want = jckpt.average_checkpoints(best)
    got = jckpt.load_params(avg)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert tckpt.load_meta(avg) == {"averaged_from": best}


def test_train_cli_mesh_matches_one_process(corpus_lists, tmp_path):
    """`cli.train --mesh dp=2` in two gloo processes (as torchrun starts
    them) writes what the one-process run writes: the same files, every
    checkpoint within 2e-5 of its one-process twin, the same CV losses
    (process 0 alone writes, and the batches' odd rows are padded with rows
    that weigh nothing)."""
    import torch_parallel_ranks
    from fangyan_tts_torch.parallel.launch import spawn

    one, two = tmp_path / "one", tmp_path / "two"
    _train(corpus_lists, "llm", one)
    argv = ["--model", "llm", "--train_data", str(corpus_lists / "train.list"), "--cv_data",
            str(corpus_lists / "cv.list"), "--model_dir", str(two), "--config", str(corpus_lists / "conf.json"),
            "--device", "cpu", "--max_epoch", "1", "--lr", "1e-3", "--max_frames_in_batch", "100",
            "--save_per_step", "1", "--log_interval", "1", "--mesh", "dp=2"]
    spawn(torch_parallel_ranks.cli_rank, 2, args=("fangyan_tts_torch.cli.train", argv), timeout=180)
    _assert_run(two)
    for n in ("init", "step_1", "step_2", "epoch_0_whole"):
        want, got = tckpt.load_params(one / f"{n}.msgpack"), tckpt.load_params(two / f"{n}.msgpack")
        jax.tree.map(lambda a, b: np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                                             rtol=2e-5, atol=2e-5), got, want)
        if n != "init":
            np.testing.assert_allclose(tckpt.load_meta(two / f"{n}.msgpack")["cv_loss"],
                                       tckpt.load_meta(one / f"{n}.msgpack")["cv_loss"], rtol=1e-5)


def test_train_cli_flow_and_resume(corpus_lists, tmp_path):
    out = tmp_path / "flow"
    _train(corpus_lists, "flow", out, "--accum_grad", "1", "--max_frames_in_batch", "2000")
    names = sorted(f.name for f in out.iterdir())
    assert "epoch_0_whole.msgpack" in names and "step_1.msgpack" in names
    tree = jckpt.load_params(out / "epoch_0_whole.msgpack")
    tm = tflow.CausalMaskedDiffWithDiT(TC.flow)
    tm.load_state_dict(flow_from_jax(tckpt.load_params(out / "epoch_0_whole.msgpack"), TC.flow))
    batch, key = flow_batch(61), jax.random.PRNGKey(4)
    want, _ = jflow.CausalMaskedDiffWithDiT(JC.flow).apply({"params": to_jax(tree)},
                                                           *(jnp.asarray(batch[k]) for k in FLOW_KEYS), key)
    with torch.no_grad():
        got, _ = tm(*(torch.from_numpy(batch[k]) for k in FLOW_KEYS), jax_draws(key, 3, batch["feat"].shape))
    _close(got, want)
    # resume: the next epoch starts from the sidecar's epoch and step
    _train(corpus_lists, "flow", out, "--accum_grad", "1", "--max_frames_in_batch", "2000", "--max_epoch", "2",
           "--checkpoint", str(out / "epoch_0_whole.msgpack"))
    meta = tckpt.load_meta(out / "epoch_1_whole.msgpack")
    assert meta["epoch"] == 1 and meta["step"] > tckpt.load_meta(out / "epoch_0_whole.msgpack")["step"]


@pytest.mark.parametrize("flag, err", [(["--mesh", "dp=2", "--device", "cpu"], ValueError),
                                       (["--dpo"], NotImplementedError), (["--device", "cuda"], RuntimeError)])
def test_train_cli_refusals(tmp_path, flag, err, monkeypatch):
    """--mesh past one process outside torchrun (WORLD_SIZE unset) and --dpo
    raise; the CLI runs on CUDA unless --device cpu, and raises without a
    card."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "x.list").write_text("")
    with pytest.raises(err):
        t_train_cli.main(["--model", "llm", "--train_data", str(tmp_path / "x.list"), "--model_dir",
                          str(tmp_path / "m"), *flag])
