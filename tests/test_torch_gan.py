"""The port's vocoder GAN training (fangyan_tts_torch/models/discriminators.py,
models/hift.CausalHiFT.forward_train, train/gan.py, cli/train_gan.py)
against the JAX package's, float32 on the CPU, with the same weights
(models/from_jax carries the trees in and, through to_jax_tree, back out):

- forward_train's audio within 1e-3 and f0 within 1e-4, and the gradients
  of a weighted sum of both within 1e-4 of each tensor's max |g| (the
  source's phase is a cumulative sum over every sample, so its gradients
  are held relative to their tensor's max, not elementwise); frames are
  voiced at about 60 Hz, so the sine phases carry gradient (F0_BIAS says
  why not higher);
- the discriminators' logits and feature maps (NCHW against flax's NHWC)
  within 1e-4 of their max, at a length that is no multiple of either
  period;
- each loss within 2e-4 relative, tpr_loss on an even count (jnp.median
  takes the mean of the two middle values, torch.median the lower), and
  its gradients;
- one generator turn and one discriminator turn from the same parameters
  against make_hifigan_steps, as tests/test_torch_train_loop.py holds the
  trainer's steps: metrics and the gradients' global norm within 2e-4
  relative, each parameter's change within 1e-3 * lr of the JAX one where
  both packages' gradients agree to 1e-3 of themselves (over half of every
  tensor of more than one element), and each turn leaves the other module
  bit-equal. The turns' L1 losses (mel, feature maps, f0) put float32
  gradients of either package 1e-4 to 2e-3 of their max away from float64,
  so the turn's gradients are not held elementwise: forward_train's and
  the losses' are, above;
- cli.train_gan --device cpu for one epoch on a tiny corpus, with the
  discriminator cut to DISC (the CLI builds the full set, and its
  1024-channel period convolutions would take minutes on one CPU thread):
  both checkpoints read by the JAX package's load_params, the generator
  vocoding there as in the port.

Sizes: HiFT base 32 (f0 conditioning 16), periods (2, 3) and one
resolution (512 / 128 / 240), 12 mel frames (12 x 480 samples)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fangyan_tts_torch.config as tcfg
import fangyan_tts_tpu.config as jcfg
from fangyan_tts_torch.cli import train_gan as t_gan_cli
from fangyan_tts_torch.config import config_to_json
from fangyan_tts_torch.data.extract import prepare_corpus
from fangyan_tts_torch.models import discriminators as tdisc
from fangyan_tts_torch.models import hift as thift
from fangyan_tts_torch.models.from_jax import discriminator_from_jax, hift_from_jax, to_jax_tree
from fangyan_tts_torch.train import checkpoint as tckpt
from fangyan_tts_torch.train import gan as tgan
from fangyan_tts_torch.train.scheduler import global_norm, plain_adam
from fangyan_tts_tpu.models import discriminators as jdisc
from fangyan_tts_tpu.models import hift as jhift
from fangyan_tts_tpu.train import checkpoint as jckpt
from fangyan_tts_tpu.train import gan as jgan
from test_torch_train_loop import _stub_models
from test_torch_train_models import assert_grads
from torch_port_util import both, capture_grads, np_params, to_jax, write_corpus

HIFT = dict(base_channels=32, f0_cond_channels=16)
DISC = dict(periods=(2, 3), fft_sizes=(512,), hop_sizes=(128,), win_lengths=(240,))
L = 12
LR = 5e-3
RTOL = 2e-4
REL_G = 1e-3
JHC, THC = jcfg.HiFTConfig(**HIFT), tcfg.HiFTConfig(**HIFT)
_ORIG_DISC = tdisc.MultipleDiscriminator
# f0 about 60 Hz: voiced frames, so the sine phases carry gradient, and phases of a few hundred radians. At
# 180 Hz (phases past 2,000 rad) the JAX package's float32 sine moves the source path's gradients by up to
# 3.6e-4 of their max from float64, where the port's stay within 2e-6
F0_BIAS = 60.0


def hift_models(seed: int = 0):
    jm = jhift.CausalHiFT(JHC)
    p = np_params(jm, seed, jnp.zeros((1, 16, 80)), gain=0.5)
    p["f0_predictor"]["classifier"]["bias"] = np.asarray([F0_BIAS], np.float32)
    tm = thift.CausalHiFT(THC)
    tm.load_state_dict(hift_from_jax(p, THC), strict=True)
    return jm, p, tm


def disc_models(seed: int = 1):
    jm = jdisc.MultipleDiscriminator(**DISC)
    p = np_params(jm, seed, jnp.zeros((1, 4800)), jnp.zeros((1, 4800)))
    rng = np.random.default_rng(seed + 100)
    for sub in p.values():  # WeightNorm scales around one (np_params draws small 1-D leaves)
        for name, wn in sub.items():
            if name.startswith("WeightNorm_"):
                for k, v in wn.items():
                    wn[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    tm = tdisc.MultipleDiscriminator(**DISC)
    tm.load_state_dict(discriminator_from_jax(p, **DISC), strict=True)
    return jm, p, tm


def gan_batch(seed: int, b: int = 2, n_frames: int = L) -> dict:
    rng = np.random.default_rng(seed)
    return {"speech": (rng.standard_normal((b, n_frames * 480)) * 0.1).astype(np.float32),
            "speech_feat": (rng.standard_normal((b, n_frames, 80)) * 0.3).astype(np.float32),
            "pitch_feat": (np.abs(rng.standard_normal((b, n_frames))) * 100).astype(np.float32)}


def _close(got, want, rtol=RTOL):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(got), float(want))


def test_forward_train_and_grads():
    jm, p, tm = hift_models()
    mel = gan_batch(0)["speech_feat"]
    rng = np.random.default_rng(1)
    wa = rng.standard_normal((2, L * 480)).astype(np.float32)
    wf = rng.standard_normal((2, L)).astype(np.float32)

    def f(params):
        audio, f0 = jm.apply({"params": params}, jnp.asarray(mel), method=jhift.CausalHiFT.forward_train)
        return jnp.sum(audio * wa) + 1e-2 * jnp.sum(f0 * wf), (audio, f0)

    (_, (audio_j, f0_j)), jg = jax.value_and_grad(f, has_aux=True)(to_jax(p))
    audio_t, f0_t = tm.forward_train(torch.from_numpy(mel))
    assert audio_t.shape == (2, L * 480) and f0_t.shape == (2, L)
    assert (np.asarray(f0_j) > JHC.nsf_voiced_threshold).mean() > 0.5
    np.testing.assert_allclose(f0_t.detach().numpy(), np.asarray(f0_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(audio_t.detach().numpy(), np.asarray(audio_j), rtol=0, atol=1e-3)
    loss = (audio_t * torch.from_numpy(wa)).sum() + 1e-2 * (f0_t * torch.from_numpy(wf)).sum()
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    assert_grads(dict(zip(dict(tm.named_parameters()), grads)), hift_from_jax(jax.device_get(jg), THC))


def test_discriminators_match_jax():
    jm, p, tm = disc_models()
    t = L * 480 + 1  # no multiple of 2 or 3: DiscriminatorP appends its reversed tail
    rng = np.random.default_rng(2)
    y, y_hat = (rng.standard_normal((2, t)) * 0.1).astype(np.float32), (rng.standard_normal((2, t)) * 0.1).astype(
        np.float32)
    want = jm.apply({"params": to_jax(p)}, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = tm(torch.from_numpy(y), torch.from_numpy(y_hat))
    for side in (0, 1):  # the logits of each discriminator
        assert len(got[side]) == len(want[side]) == 3
        for g, w in zip(got[side], want[side]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    for side in (2, 3):  # six feature maps a discriminator, channels moved to the end
        for fg, fw in zip(got[side], want[side]):
            assert len(fg) == len(fw) == 6
            for g, w in zip(fg, fw):
                w = np.asarray(w)
                np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_discriminator_checkpoint_round_trip():
    """to_jax_tree gives the JAX tree back (every WeightNorm scale in its
    WeightNorm_i entry)."""
    _, p, tm = disc_models(3)
    back = to_jax_tree(tm.state_dict(), tm)
    jax.tree.map(np.testing.assert_array_equal, back, jax.device_get(p))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_losses_match_jax():
    dr = [_rand(i, 2, 5) for i in range(3)]  # 10 entries a discriminator: an even count
    dg = [_rand(10 + i, 2, 5) for i in range(3)]
    fr = [[_rand(20 + i, 2, 3, 4), _rand(30 + i, 2, 7)] for i in range(3)]
    fg = [[_rand(40 + i, 2, 3, 4), _rand(50 + i, 2, 7)] for i in range(3)]
    real, gen = _rand(60, 2, 5 * 480 + 17) * 0.1, _rand(61, 2, 5 * 480 + 9) * 0.1
    T = lambda xs: [torch.from_numpy(x) for x in xs]
    J = lambda xs: [jnp.asarray(x) for x in xs]
    # the even count: the mean of the two middle values, where torch.median takes the lower
    diff = torch.from_numpy(dr[0] - dg[0])
    assert float(tgan.median(diff)) == pytest.approx(float(jnp.median(jnp.asarray(dr[0] - dg[0]))), abs=1e-7)
    assert float(torch.median(diff)) != pytest.approx(float(tgan.median(diff)), abs=1e-6)
    _close(tgan.generator_adv_loss(T(dg)), jgan.generator_adv_loss(J(dg)))
    _close(tgan.discriminator_adv_loss(T(dr), T(dg)), jgan.discriminator_adv_loss(J(dr), J(dg)))
    _close(tgan.feature_match_loss([T(x) for x in fr], [T(x) for x in fg]),
           jgan.feature_match_loss([J(x) for x in fr], [J(x) for x in fg]))
    _close(tgan.tpr_loss(T(dr), T(dg), tau=10.0), jgan.tpr_loss(J(dr), J(dg), tau=10.0))
    _close(tgan.tpr_loss(T(dr), T(dg)), jgan.tpr_loss(J(dr), J(dg)))
    _close(tgan.mel_l1_loss(torch.from_numpy(real), torch.from_numpy(gen)),
           jgan.mel_l1_loss(jnp.asarray(real), jnp.asarray(gen)))
    # gradients: tpr through the median (tau above every l_rel, so none is truncated) and the mel L1
    jg = jax.grad(lambda a, b: jgan.tpr_loss(a, b, tau=10.0), argnums=(0, 1))(J(dr), J(dg))
    tr, tg = [x.requires_grad_() for x in T(dr)], [x.requires_grad_() for x in T(dg)]
    got = torch.autograd.grad(tgan.tpr_loss(tr, tg, tau=10.0), tr + tg)
    for g, w in zip(got, jg[0] + jg[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * np.abs(np.asarray(w)).max())
    jgm = jax.grad(jgan.mel_l1_loss, argnums=1)(jnp.asarray(real), jnp.asarray(gen))
    tgen = torch.from_numpy(gen).requires_grad_()
    (gm,) = torch.autograd.grad(tgan.mel_l1_loss(torch.from_numpy(real), tgen), [tgen])
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=0, atol=1e-4 * np.abs(np.asarray(jgm)).max())


def _assert_stepped_alike(module, before: dict, want: dict, tgrads: dict, jgrads: dict):
    """Each parameter's change within 1e-3 * LR of the JAX one where the two
    gradients agree to REL_G of the JAX one (Adam divides by the gradient's
    own size; tests/test_torch_train_loop.py says why), over half of every
    tensor of more than one element."""
    for k, v in module.named_parameters():
        skip = (tgrads[k] - jgrads[k]).abs() > REL_G * jgrads[k].abs()
        err = ((v.detach() - before[k]) - (want[k] - before[k])).abs()[~skip]
        assert v.numel() == 1 or skip.float().mean() < 0.5, (k, float(skip.float().mean()))
        assert err.numel() == 0 or float(err.max()) <= 1e-3 * LR, (k, float(err.max()))


def _port_grads(turn: str, g0: dict, d0: dict, batch: dict) -> dict:
    """The port's gradients of one turn at the starting weights, on fresh
    modules (the steps update theirs in place)."""
    th, td = thift.CausalHiFT(THC), tdisc.MultipleDiscriminator(**DISC)
    th.load_state_dict(g0)
    td.load_state_dict(d0)
    feat, speech, pitch = (torch.from_numpy(batch[k]) for k in ("speech_feat", "speech", "pitch_feat"))
    if turn == "generator":
        audio, f0 = th.forward_train(feat)
        y_d_rs, y_d_gs, fr, fg = td(speech, audio)
        loss = (tgan.generator_adv_loss(y_d_gs) + 2.0 * tgan.feature_match_loss(fr, fg)
                + 45.0 * tgan.mel_l1_loss(speech, audio) + tgan.tpr_loss(y_d_gs, y_d_rs, 0.04)
                + (f0 - pitch).abs().mean())
        own = th
    else:
        with torch.no_grad():
            audio, _ = th.forward_train(feat)
        y_d_rs, y_d_gs, _, _ = td(speech, audio)
        loss = tgan.discriminator_adv_loss(y_d_rs, y_d_gs) + tgan.tpr_loss(y_d_rs, y_d_gs, 0.04)
        own = td
    return dict(zip(dict(own.named_parameters()), torch.autograd.grad(loss, list(own.parameters()))))


@pytest.mark.parametrize("turn", ["generator", "discriminator"])
def test_gan_turn_matches_jax(turn):
    jh, gp, th = hift_models(4)
    jd, dp, td = disc_models(5)
    batch = gan_batch(6)
    g0 = {k: v.clone() for k, v in th.state_dict().items()}
    d0 = {k: v.clone() for k, v in td.state_dict().items()}
    jtx = optax.chain(capture_grads(), optax.adam(LR))
    jstate = jgan.init_gan_state(to_jax(gp), to_jax(dp), jtx, jtx)
    jstep = dict(zip(("generator", "discriminator"), jgan.make_hifigan_steps(jh, jd, jtx, jtx)))[turn]
    tstate = tgan.init_gan_state(th, td, plain_adam(LR), plain_adam(LR))
    tstep = dict(zip(("generator", "discriminator"), tgan.make_hifigan_steps(th, td, plain_adam(LR),
                                                                              plain_adam(LR))))[turn]
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm_ = tstep(tstate, batch)
    assert sorted(tm_) == sorted(jm) and tstate.step == int(jstate.step)
    for k in jm:
        _close(tm_[k], jm[k])
    tgrads = _port_grads(turn, g0, d0, batch)
    if turn == "generator":
        jgrads = hift_from_jax(jax.device_get(jstate.gen_opt[0]), THC)
        want = hift_from_jax(jax.device_get(jstate.gen_params), THC)
        _assert_stepped_alike(th, g0, want, tgrads, jgrads)
        assert all(torch.equal(v, d0[k]) for k, v in td.state_dict().items())  # the other module untouched
    else:
        jgrads = discriminator_from_jax(jax.device_get(jstate.disc_opt[0]), **DISC)
        want = discriminator_from_jax(jax.device_get(jstate.disc_params), **DISC)
        _assert_stepped_alike(td, d0, want, tgrads, jgrads)
        assert all(torch.equal(v, g0[k]) for k, v in th.state_dict().items())
    _close(global_norm(list(tgrads.values())), global_norm(list(jgrads.values())))


@pytest.fixture(scope="module")
def gan_corpus(tmp_path_factory):
    """Four utterances of 1-1.9 s through the port's prepare_corpus with stub
    models, two a shard: shard 0 is the train list; the tiny HiFT config."""
    root = tmp_path_factory.mktemp("gan_corpus")
    write_corpus(root, [16000 + 3000 * i for i in range(4)], seed=12, spk_size=2)
    shards = prepare_corpus(root, root / "pq", *_stub_models(), batch_size=2, num_utts_per_parquet=2, device="cpu")
    (root / "train.list").write_text(shards[0] + "\n")
    _, tc = both()
    (root / "conf.json").write_text(config_to_json(tcfg.CosyVoiceConfig(llm=tc.llm, flow=tc.flow, hift=THC)))
    return root


def test_train_gan_cli(gan_corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(tdisc, "MultipleDiscriminator", lambda: _ORIG_DISC(**DISC))
    out = tmp_path / "gan"
    t_gan_cli.main(["--train_data", str(gan_corpus / "train.list"), "--model_dir", str(out), "--config",
                    str(gan_corpus / "conf.json"), "--max_epoch", "1", "--log_interval", "1", "--device", "cpu"])
    assert sorted(f.name for f in out.iterdir()) == ["epoch_0_disc.msgpack", "epoch_0_disc.msgpack.json",
                                                     "epoch_0_whole.msgpack", "epoch_0_whole.msgpack.json"]
    for n in ("whole", "disc"):
        assert tckpt.load_meta(out / f"epoch_0_{n}.msgpack") == {"epoch": 0}
    # both read by the JAX package; the generator vocodes there as in the port
    gen_tree = jckpt.load_params(out / "epoch_0_whole.msgpack")
    disc_tree = jckpt.load_params(out / "epoch_0_disc.msgpack")
    disc = _ORIG_DISC(**DISC)
    disc.load_state_dict(discriminator_from_jax(disc_tree, **DISC), strict=True)
    hift = thift.CausalHiFT(THC)
    hift.load_state_dict(hift_from_jax(gen_tree, THC), strict=True)
    mel = gan_batch(7, b=1)["speech_feat"]
    want, _ = jhift.CausalHiFT(JHC).apply({"params": to_jax(gen_tree)}, jnp.asarray(mel))
    with torch.no_grad():
        got, _ = hift(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    assert np.isfinite(got.numpy()).all() and np.abs(got.numpy()).max() > 0


@pytest.mark.parametrize("flag, err", [(["--mesh", "dp=2", "--device", "cpu"], ValueError),
                                       (["--device", "cuda"], RuntimeError)])
def test_train_gan_cli_refusals(tmp_path, flag, err, monkeypatch):
    """--mesh past one process outside torchrun (WORLD_SIZE unset) raises;
    the CLI runs on CUDA unless --device cpu, and raises without a card."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "x.list").write_text("")
    with pytest.raises(err):
        t_gan_cli.main(["--train_data", str(tmp_path / "x.list"), "--model_dir", str(tmp_path / "m"), *flag])
