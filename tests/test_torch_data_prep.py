"""The port's data prep (stages 1-4) against the JAX package's, float32 on
the CPU, with the same weights (the JAX trees made by
campplus_params_from_torch / s3_params_from_torch from the tests/oracles
modules at torch_port_util's FE_CAMP / FE_S3 sizes, carried into the port by
make_campplus_fn / make_s3_fn). The corpus has rows in the 1 s, 2 s and 3 s
buckets, each shorter than its bucket, and two speakers whose utterances
alternate between buckets.

Tolerances:
- `embed_features` / `token_features` within 1e-4 of `_embed_features` /
  `_token_features` (an fbank element past it must be within 1e-4 of a
  float64 reference and no further from it than the JAX value, the arbiter
  of tests/test_torch_mel.py);
- S3 codes and code lengths bit-equal; x-vectors and speaker means within
  CAM++'s atol 2e-4 / rtol 2e-3 (tests/test_campplus_parity.py);
- parquet shards: every column but the two embedding columns equal, those
  within the x-vector limits; `extract_all` (one upload, the fused
  per-batch function) against the separate stages `extract_embeddings` +
  `extract_speech_tokens` (each its own load and upload), and
  `prepare_corpus` against `extract_all` + `make_parquet_list`: x-vectors
  within 1e-5, codes equal (the same operations in the same order);
- `build_pipeline`: llm-mode batches equal; flow-mode mels within 1e-4,
  the rest equal;
- the native loader bit-equal to the numpy reader (both read 16-bit PCM),
  its resampler within 2e-4 of the numpy one away from the edges.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from fangyan_tts_torch.data import dataset as tds
from fangyan_tts_torch.data import extract as tex
from fangyan_tts_torch.data import native as tnative
from fangyan_tts_torch.data.audio import read_wav, resample_poly
from fangyan_tts_torch.data.parquet import make_parquet_list as t_make_parquet_list
from fangyan_tts_torch.infer.frontend import make_campplus_fn, make_s3_fn
from fangyan_tts_tpu.config import LLMConfig as JaxLLMConfig
from fangyan_tts_tpu.data import dataset as jds
from fangyan_tts_tpu.data import extract as jex
from fangyan_tts_tpu.models.campplus import CAMPPlus
from fangyan_tts_tpu.models.convert import campplus_params_from_torch, s3_params_from_torch
from fangyan_tts_tpu.models.s3tokenizer import S3TokenizerV3
from fangyan_tts_tpu.ops.mel import matcha_mel as jax_matcha_mel
from fangyan_tts_torch.config import LLMConfig as TorchLLMConfig
from test_torch_mel import _assert_mel_close, _kaldi_fbank_f64
from torch_port_util import (FE_CAMP, FE_S3, campplus_kwargs, campplus_oracle, s3_kwargs, s3_oracle, speech_like,
                             write_corpus)

XVEC_ATOL, XVEC_RTOL = 2e-4, 2e-3
FEAT_ATOL = 1e-4
ROUTE_ATOL = 1e-5
# samples: 1 s bucket 11,000 and 14,500; 2 s bucket 20,000, 29,000 and 31,999;
# 3 s bucket 40,000 (speaker-major: spk0 takes the first four)
LENGTHS = (20000, 11000, 40000, 14500, 29000, 16000, 31999, 12345)
BATCH = 2  # 1 s bucket 4 rows, 2 s bucket 3, 3 s bucket 1: six batches, past MAX_INFLIGHT


@pytest.fixture(scope="module")
def models():
    camp = campplus_params_from_torch(campplus_oracle(FE_CAMP, 31).state_dict(), FE_CAMP["block_layers"])
    s3, _ = s3_params_from_torch(s3_oracle(FE_S3, 32).state_dict())
    jkw, tkw = campplus_kwargs(FE_CAMP)
    cm, sm = CAMPPlus(**jkw), S3TokenizerV3(**s3_kwargs(FE_S3))
    jcamp = jax.jit(lambda f: cm.apply({"params": camp}, f))
    js3 = jax.jit(lambda m, n: sm.apply({"params": s3}, m, n))
    tcamp = make_campplus_fn(camp, device="cpu", dtype=torch.float32, **tkw)
    ts3 = make_s3_fn(s3, device="cpu", dtype=torch.float32, **s3_kwargs(FE_S3))
    return {"jax": (lambda f, fl: jcamp(f), js3), "torch": (lambda f, fl: tcamp(f), ts3)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    write_corpus(root, LENGTHS, seed=5)
    return root


def _copy(src: Path, dst: Path) -> Path:
    """The Kaldi files of `src` (not its artifacts) in `dst`, wav.scp still
    naming src's wavs, so the shards' wav columns agree."""
    dst.mkdir(parents=True)
    for name in ("wav.scp", "text", "utt2spk", "spk2utt", "instruct"):
        shutil.copy(src / name, dst / name)
    return dst


def _load_pt(path: Path) -> dict:
    return {k: v.numpy() for k, v in torch.load(path, weights_only=False).items()}


def _assert_xvecs(got: dict, want: dict, atol=XVEC_ATOL, rtol=XVEC_RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=k)


def _assert_tokens(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _batch(lengths, seed):
    rng = np.random.default_rng(seed)
    utts = [(f"u{i}", speech_like(n, 16000, rng)) for i, n in enumerate(lengths)]
    ((_, pad, lens),) = list(tex._batched_buckets(utts, 16000, 8))
    return pad, lens


@pytest.mark.parametrize("lengths", [(11000, 16000, 9001), (20000, 31999)])
def test_features_match_jax(lengths):
    pad, lens = _batch(lengths, seed=len(lengths))
    assert pad.dtype == np.int16 and pad.shape[1] in (16000, 32000) and lens.max() <= pad.shape[1]
    feats, frame_len = tex.embed_features(torch.from_numpy(pad), torch.from_numpy(lens))
    jfeats, jframe_len = jex._embed_features(jnp.asarray(pad), jnp.asarray(lens))
    np.testing.assert_array_equal(frame_len.numpy(), np.asarray(jframe_len))
    # the float64 arbiter of tests/test_torch_mel.py, with the masked mean subtraction
    fb = _kaldi_fbank_f64(pad.astype(np.float64) / 32768.0)
    mask = (np.arange(fb.shape[1])[None, :] < frame_len.numpy()[:, None])[..., None]
    ref64 = (fb - (fb * mask).sum(1, keepdims=True) / frame_len.numpy()[:, None, None]) * mask
    _assert_mel_close(feats.numpy(), np.asarray(jfeats), ref64)
    assert all((feats.numpy()[b, int(n):] == 0).all() for b, n in enumerate(frame_len))
    mel, mel_len = tex.token_features(torch.from_numpy(pad), torch.from_numpy(lens))
    jmel, jmel_len = jex._token_features(jnp.asarray(pad), jnp.asarray(lens))
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(jmel_len))
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), rtol=0, atol=FEAT_ATOL)


def test_batched_buckets_match_jax():
    rng = np.random.default_rng(3)
    utts = [(f"u{i}", speech_like(n, 16000, rng)) for i, n in enumerate((*LENGTHS, 16000 * 31))]
    for a, b in zip(tex._batched_buckets(utts, 16000, BATCH), jex._batched_buckets(utts, 16000, BATCH), strict=True):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert max(len(b[2]) for b in tex._batched_buckets(utts, 16000, BATCH)) == BATCH
    assert tex._bucket_len(16000 * 31, 16000) == 16000 * 30  # the 30 s guard


def test_extract_all_matches_jax(models, corpus, tmp_path):
    jdir, tdir = _copy(corpus, tmp_path / "jax"), _copy(corpus, tmp_path / "torch")
    jex.extract_all(jdir, *models["jax"], batch_size=BATCH)
    emb, tok = tex.extract_all(tdir, *models["torch"], batch_size=BATCH, device="cpu")
    assert sorted(emb) == sorted(tok) == sorted(f"utt{i:03d}" for i in range(len(LENGTHS)))
    _assert_tokens(_load_pt(tdir / "utt2speech_token.pt"), _load_pt(jdir / "utt2speech_token.pt"))
    # code lengths follow the true lengths, not the buckets: ((n // 160 + 1) // 2 + 1) // 2
    assert [len(tok[f"utt{i:03d}"]) for i in range(len(LENGTHS))] == [
        ((n // 160 + 1) // 2 + 1) // 2 for n in LENGTHS]
    assert len(np.unique(np.concatenate(list(tok.values())))) > 5
    _assert_xvecs(_load_pt(tdir / "utt2embedding.pt"), _load_pt(jdir / "utt2embedding.pt"))
    spk = _load_pt(tdir / "spk2embedding.pt")
    assert sorted(spk) == ["spk0", "spk1"]
    _assert_xvecs(spk, _load_pt(jdir / "spk2embedding.pt"))


def test_single_stages_match_extract_all(models, corpus, tmp_path):
    """The separate stages, extract_embeddings and extract_speech_tokens
    (the two CLIs' calls, each loading and uploading the corpus), write what
    extract_all's fused route writes."""
    adir, sdir = _copy(corpus, tmp_path / "all"), _copy(corpus, tmp_path / "single")
    tex.extract_all(adir, *models["torch"], batch_size=BATCH, device="cpu")
    camp, s3 = models["torch"]
    tex.extract_embeddings(sdir, camp, batch_size=BATCH, device="cpu")
    tex.extract_speech_tokens(sdir, s3, batch_size=BATCH, device="cpu")
    for name in ("utt2embedding.pt", "spk2embedding.pt"):
        _assert_xvecs(_load_pt(sdir / name), _load_pt(adir / name), atol=ROUTE_ATOL, rtol=0)
    _assert_tokens(_load_pt(sdir / "utt2speech_token.pt"), _load_pt(adir / "utt2speech_token.pt"))


def _columns(path: str) -> dict:
    return pq.read_table(path).to_pydict()


def _assert_shards(got_list: Path, want_list: Path, xvec_limits: tuple[float, float]):
    got, want = got_list.read_text().splitlines(), want_list.read_text().splitlines()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert Path(g).name == Path(w).name
        cg, cw = _columns(g), _columns(w)
        assert list(cg) == list(cw)
        assert {"sample_rate", "num_samples", "instruct", "audio_data"} <= set(cg)
        for col in cw:
            if col in ("utt_embedding", "spk_embedding"):
                np.testing.assert_allclose(np.asarray(cg[col], np.float32), np.asarray(cw[col], np.float32),
                                           atol=xvec_limits[0], rtol=xvec_limits[1], err_msg=col)
            else:
                assert cg[col] == cw[col], col
    for name in ("utt2data.list", "spk2data.list"):
        assert len((got_list.parent / name).read_text().splitlines()) == 3


@pytest.mark.parametrize("batch_size", [1, BATCH])
def test_prepare_corpus_matches_sequential(models, corpus, tmp_path, batch_size):
    """prepare_corpus against extract_all + make_parquet_list of the port:
    the same .pt maps and shards, at batch 1 (every utterance a batch of its
    own: eight batches through the four-deep window) and at BATCH (the
    buckets split into six batches)."""
    seq, pipe = _copy(corpus, tmp_path / "seq"), _copy(corpus, tmp_path / "pipe")
    camp, s3 = models["torch"]
    tex.extract_all(seq, camp, s3, batch_size=batch_size, device="cpu")
    t_make_parquet_list(seq, seq / "pq", num_utts_per_parquet=3, instruct=True)
    shards = tex.prepare_corpus(pipe, pipe / "pq", camp, s3, batch_size=batch_size, num_utts_per_parquet=3,
                                instruct=True, device="cpu")
    assert shards == (pipe / "pq" / "data.list").read_text().splitlines()
    for name in ("utt2embedding.pt", "spk2embedding.pt"):
        _assert_xvecs(_load_pt(pipe / name), _load_pt(seq / name), atol=ROUTE_ATOL, rtol=0)
    _assert_tokens(_load_pt(pipe / "utt2speech_token.pt"), _load_pt(seq / "utt2speech_token.pt"))
    _assert_shards(pipe / "pq" / "data.list", seq / "pq" / "data.list", (ROUTE_ATOL, 0))


@pytest.fixture(scope="module")
def shards(models, corpus, tmp_path_factory):
    """The JAX package's and the port's prepare_corpus on one corpus."""
    root = tmp_path_factory.mktemp("shards")
    out = {}
    for side in ("jax", "torch"):
        d = _copy(corpus, root / side)
        kw = {} if side == "jax" else {"device": "cpu"}
        (jex if side == "jax" else tex).prepare_corpus(d, d / "pq", *models[side], batch_size=BATCH,
                                                       num_utts_per_parquet=3, instruct=True, **kw)
        out[side] = d / "pq" / "data.list"
    return out


def test_shards_match_jax(shards):
    _assert_shards(shards["torch"], shards["jax"], (XVEC_ATOL, XVEC_RTOL))


class _Tok:
    def encode(self, s, **kw):
        return list(s.encode("utf-8"))


@pytest.mark.parametrize("epoch", [0, 1])
def test_llm_pipeline_matches_jax(shards, epoch):
    """mode='llm' from the JAX package's shards: the same batches (ids,
    targets, sources, lengths), with the same bistream coin flips."""
    kw = dict(mode="llm", epoch=epoch, shuffle_size=4, sort_size=3, max_frames_in_batch=200)
    got = list(tds.build_pipeline(str(shards["jax"]), _Tok(), None, llm_cfg=TorchLLMConfig(), **kw))
    want = list(jds.build_pipeline(str(shards["jax"]), _Tok(), None, llm_cfg=JaxLLMConfig(), **kw))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and "ids" in g and g["ids"].ndim == 2
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
    stacked = list(tds.stack_microbatches(iter(got), 2))
    want_stacked = list(jds.stack_microbatches(iter(want), 2))
    for g, w in zip(stacked, want_stacked, strict=True):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_flow_pipeline_matches_jax(shards):
    """mode='flow' from the port's shards: mels by make_mel_fn (matcha_mel on
    the CPU here) against the JAX package's matcha_mel."""
    kw = dict(mode="flow", shuffle_size=4, sort_size=3, max_frames_in_batch=400)
    got = list(tds.build_pipeline(str(shards["torch"]), _Tok(), tds.make_mel_fn("cpu"), **kw))
    want = list(jds.build_pipeline(str(shards["torch"]), _Tok(),
                                   lambda a: np.asarray(jax_matcha_mel(jnp.asarray(a))), **kw))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["feat"].shape == w["feat"].shape and g["feat"].shape[2] == 80
        np.testing.assert_allclose(g["feat"], w["feat"], rtol=0, atol=FEAT_ATOL)
        for k in ("token", "token_len", "feat_len", "embedding"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_make_mel_fn_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is served")
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.make_mel_fn()


def test_native_loader(corpus, tmp_path, monkeypatch):
    """The native library is built from csrc/audio_io.cpp into build/native
    (here a copy of the source into a fresh directory) and reads the wavs
    as the numpy reader does; nothing is written beside the source, so the
    tracked csrc/libfangyan_audio.so is never touched."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler: the numpy fallback serves")
    repo = Path(__file__).resolve().parents[1]
    assert tnative.SOURCE == repo / "csrc" / "audio_io.cpp" and tnative.BUILD_DIR == repo / "build" / "native"
    src = tmp_path / "csrc" / "audio_io.cpp"
    src.parent.mkdir()
    shutil.copy(tnative.SOURCE, src)
    monkeypatch.setattr(tnative, "SOURCE", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build" / "native")
    tnative._load.cache_clear()
    try:
        assert tnative.available()
        built = tnative.library_path()
        assert built.exists() and built.parent == tmp_path / "build" / "native"
        assert str(built) in tnative.loader()
        assert [p.name for p in built.parent.iterdir()] == [built.name]  # no temporary left behind
        assert [p.name for p in src.parent.iterdir()] == ["audio_io.cpp"]
        paths = [str(p) for p in sorted((corpus / "wavs").glob("*.wav"))]
        audio, lengths, rates = tnative.load_wav_batch(paths, 48000)
        for i, p in enumerate(paths):
            ref, sr = read_wav(p)
            assert rates[i] == sr == 16000 and lengths[i] == len(ref)
            np.testing.assert_array_equal(audio[i, : lengths[i]], ref)
        got, sr = tnative.parse_wav_bytes(Path(paths[0]).read_bytes())
        np.testing.assert_array_equal(got, read_wav(paths[0])[0])
        x = speech_like(16000, 16000, np.random.default_rng(2))
        a, b = tnative.resample_native(x, 16000, 24000), resample_poly(x, 16000, 24000)
        n = min(len(a), len(b))
        np.testing.assert_allclose(a[100 : n - 100], b[100 : n - 100], atol=2e-4)
        utts = tex.load_utts({Path(p).stem: p for p in paths})
        monkeypatch.setattr(tnative, "_load", lambda: None)  # the numpy fallback serves the same rows
        fallback = tex.load_utts({Path(p).stem: p for p in paths})
        assert "numpy" in tnative.loader()
        for (u, a), (v, b) in zip(utts, fallback, strict=True):
            assert u == v
            np.testing.assert_array_equal(a, b)
    finally:
        monkeypatch.undo()
        tnative._load.cache_clear()


@pytest.mark.parametrize("stage", ["prepare_corpus", "extract_all"])
def test_unreadable_wav_raises(tmp_path, stage):
    """One wav of shard 0 is not a RIFF file (6 utterances of 2 speakers, 2
    a shard): both passes raise, naming it, before anything is packed or
    written, where the JAX package drops it and returns a partial result."""
    wav_scp = write_corpus(tmp_path, [16000] * 6, seed=3, spk_size=3)
    Path(wav_scp["utt001"]).write_bytes(b"not a wav file" * 100)

    def emb(feats, frame_len):
        return torch.zeros(feats.shape[0], 192)

    def tok(mel, mel_len):
        return torch.zeros(mel.shape[0], 4, dtype=torch.int32), torch.full((mel.shape[0],), 4, dtype=torch.int32)

    with pytest.raises(RuntimeError, match="utt001") as err:
        if stage == "prepare_corpus":
            tex.prepare_corpus(tmp_path, tmp_path / "pq", emb, tok, batch_size=2, num_utts_per_parquet=2,
                               device="cpu")
        else:
            tex.extract_all(tmp_path, emb, tok, batch_size=2, device="cpu")
    assert "1 of 6" in str(err.value)
    assert not list(tmp_path.glob("*.pt")) and not list(tmp_path.glob("pq/*.tar"))
