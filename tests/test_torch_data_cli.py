"""The port's stage CLIs (fangyan_tts_torch/cli/), on the CPU:
- extract_embedding and extract_speech_token with --device cpu, their
  weights from --checkpoint (a msgpack written by the port's save_params)
  or --onnx_path (a graph written by data/onnx_proto.save_model from the
  tests/oracles modules), write the artifacts the library calls write with
  the same weights in bf16 (bit-equal: the same operations). CAM++ is full
  size (the CLI's architecture, 52 dense layers) with weights scaled so its
  activations stay of order one; S3 is 2 layers of 80 with 20 heads (the
  CLI reads width, depth, mels and FSMN kernel from the weights);
- make_parquet_list writes the shards parquet.make_parquet_list writes;
- stats_duration (--json and the table) and prepare_training_data (modes
  instruct, combine, validate, all) give the JAX CLIs' output files and
  printout (but the banner's name) on the same mini dataset;
- without --device cpu, an extraction CLI exits non-zero on a host with no
  CUDA device."""

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from fangyan_tts_torch.cli import extract_embedding as t_emb_cli
from fangyan_tts_torch.cli import extract_speech_token as t_tok_cli
from fangyan_tts_torch.cli import make_parquet_list as t_pq_cli
from fangyan_tts_torch.cli import prepare_training_data as t_prep_cli
from fangyan_tts_torch.cli import stats_duration as t_stats_cli
from fangyan_tts_torch.data.audio import write_wav
from fangyan_tts_torch.data.extract import extract_embeddings, extract_speech_tokens
from fangyan_tts_torch.data.onnx_proto import save_model
from fangyan_tts_torch.data.parquet import make_parquet_list
from fangyan_tts_torch.infer.frontend import make_campplus_fn, make_s3_fn
from fangyan_tts_torch.models.convert import campplus_params_from_torch, s3_params_from_torch
from fangyan_tts_torch.train.checkpoint import save_params
from fangyan_tts_tpu.cli import prepare_training_data as j_prep_cli
from fangyan_tts_tpu.cli import stats_duration as j_stats_cli
from torch_port_util import s3_oracle, speech_like, write_corpus

REPO = Path(__file__).resolve().parents[1]
CAMP_FULL = dict(feat_dim=80, embedding_size=192, growth_rate=32, bn_size=4, init_channels=128,
                 block_layers=(12, 24, 16))
S3_CLI = dict(n_mels=128, n_state=80, n_head=20, n_layer=2, kernel_size=7)
LENGTHS = (14000, 25000, 9000, 30000, 16000)


def _campplus_full(seed: int):
    """The oracle CAM++ at full size, eval mode: weights N(0, 2 / fan_in),
    BatchNorm running var U(0.5, 1.5), means and biases N(0, 0.01)."""
    from oracles.campplus_torch import CAMPPlus

    gen = torch.Generator().manual_seed(seed)
    m = CAMPPlus(**CAMP_FULL).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(2.0 / math.prod(p.shape[1:])))
            else:
                p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * torch.randn(p.shape, generator=gen))
        for mod in m.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=gen) + 0.5)
    return m


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    camp, s3 = _campplus_full(51), s3_oracle(S3_CLI, 52)
    out = {}
    for name, module, tree in (("campplus", camp, campplus_params_from_torch(camp.state_dict())),
                               ("s3", s3, s3_params_from_torch(s3.state_dict())[0])):
        save_params(d / f"{name}.msgpack", tree)
        save_model(str(d / f"{name}.onnx"), nodes=[], initializers={k: v.numpy() for k, v in module.state_dict().items()},
                   inputs=["feats"], outputs=["out"])
        out[name] = tree
    return d, out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_corpus")
    write_corpus(root, LENGTHS, seed=9, spk_size=3)
    return root


def _kaldi_copy(src: Path, dst: Path) -> Path:
    dst.mkdir(parents=True)
    for name in ("wav.scp", "text", "utt2spk", "spk2utt", "instruct"):
        shutil.copy(src / name, dst / name)
    return dst


def _pt(path: Path) -> dict:
    return {k: v.numpy() for k, v in torch.load(path, weights_only=False).items()}


def _assert_same_pt(a: Path, b: Path):
    x, y = _pt(a), _pt(b)
    assert sorted(x) == sorted(y) and len(x) > 0
    for k in y:
        assert x[k].dtype == y[k].dtype, k
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("source", ["checkpoint", "onnx_path"])
@pytest.mark.parametrize("stage", ["embedding", "speech_token"])
def test_extraction_cli_matches_library(weights, corpus, tmp_path, stage, source):
    d, trees = weights
    name = "campplus" if stage == "embedding" else "s3"
    cli_dir, lib_dir = _kaldi_copy(corpus, tmp_path / "cli"), _kaldi_copy(corpus, tmp_path / "lib")
    path = d / (f"{name}.msgpack" if source == "checkpoint" else f"{name}.onnx")
    cli = t_emb_cli if stage == "embedding" else t_tok_cli
    cli.main(["--dir", str(cli_dir), f"--{source}", str(path), "--batch-size", "2", "--device", "cpu"])
    if stage == "embedding":
        camp = make_campplus_fn(trees["campplus"], device="cpu", dtype=torch.bfloat16)
        extract_embeddings(lib_dir, lambda f, fl: camp(f), batch_size=2, device="cpu")
        names = ("utt2embedding.pt", "spk2embedding.pt")
        emb = _pt(cli_dir / "utt2embedding.pt")
        assert all(np.isfinite(v).all() and v.shape == (192,) for v in emb.values())
        assert np.abs(emb["utt000"] - emb["utt001"]).max() > 1e-3  # the utterances differ
    else:
        kw = dict(dim=S3_CLI["n_state"], heads=S3_CLI["n_head"], layers=S3_CLI["n_layer"],
                  n_mels=S3_CLI["n_mels"], fsmn_kernel=S3_CLI["kernel_size"])
        extract_speech_tokens(lib_dir, make_s3_fn(trees["s3"], device="cpu", dtype=torch.bfloat16, **kw),
                              batch_size=2, device="cpu")
        names = ("utt2speech_token.pt",)
    for n in names:
        _assert_same_pt(cli_dir / n, lib_dir / n)


def test_make_parquet_list_cli(weights, corpus, tmp_path):
    d, _ = weights
    src = _kaldi_copy(corpus, tmp_path / "src")
    t_emb_cli.main(["--dir", str(src), "--checkpoint", str(d / "campplus.msgpack"), "--device", "cpu"])
    t_tok_cli.main(["--dir", str(src), "--onnx_path", str(d / "s3.onnx"), "--device", "cpu"])
    t_pq_cli.main(["--src_dir", str(src), "--des_dir", str(tmp_path / "cli"), "--num_utts_per_parquet", "2",
                   "--instruct"])
    shards = make_parquet_list(src, tmp_path / "lib", num_utts_per_parquet=2, instruct=True)
    assert len(shards) == 3
    cli_list = (tmp_path / "cli" / "data.list").read_text().splitlines()
    assert [Path(p).name for p in cli_list] == [Path(p).name for p in shards]
    for a, b in zip(cli_list, shards):
        ta, tb = pq.read_table(a).to_pydict(), pq.read_table(b).to_pydict()
        assert ta == tb
    assert set(sum((pq.read_table(p).to_pydict()["utt"] for p in shards), [])) == {f"utt{i:03d}" for i in
                                                                                     range(len(LENGTHS))}


def _dataset(root: Path) -> Path:
    """dataset/<dialect>/{wavs, Kaldi files} for two dialects, wav.scp paths
    relative (so two copies have equal files), one with instruct.txt."""
    rng = np.random.default_rng(12)
    for di, dialect in enumerate(("sichuan", "henan")):
        d = root / dialect
        (d / "wavs").mkdir(parents=True)
        lines = {"wav.scp": [], "text": [], "utt2spk": []}
        for i in range(3):
            u = f"{dialect}_{i}"
            write_wav(d / "wavs" / f"{u}.wav", speech_like(8000 + 3000 * i + 1000 * di, 16000, rng), 16000)
            lines["wav.scp"].append(f"{u} wavs/{u}.wav")
            lines["text"].append(f"{u} 第{i}句话。")
            lines["utt2spk"].append(f"{u} {dialect}_spk")
        for name, ls in lines.items():
            (d / name).write_text("\n".join(ls) + "\n", encoding="utf-8")
        (d / "spk2utt").write_text(f"{dialect}_spk {' '.join(f'{dialect}_{i}' for i in range(3))}\n")
    (root / "henan" / "instruct.txt").write_text("".join(f"henan_{i} 请用河南话说。<|endofprompt|>\n" for i in range(3)))
    (root / "sichuan" / "wavs" / "broken.wav").write_bytes(b"not a wav")
    return root


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _run(main, argv, capsys) -> str:
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("as_json", [True, False])
def test_stats_duration_matches_jax(tmp_path, capsys, as_json):
    ds = _dataset(tmp_path / "dataset")
    argv = ["--dataset-dir", str(ds)] + (["--json"] if as_json else [])
    got, want = _run(t_stats_cli.main, argv, capsys), _run(j_stats_cli.main, argv, capsys)
    assert got == want
    if as_json:
        out = json.loads(got)
        assert [d["name"] for d in out["dialects"]] == ["henan", "sichuan"]
        assert out["summary"]["total_files"] == 6
        assert [d["failed_files_count"] for d in out["dialects"]] == [0, 1]


@pytest.mark.parametrize("mode", ["instruct", "combine", "validate", "all"])
def test_prepare_training_data_matches_jax(tmp_path, capsys, mode):
    tdir, jdir = _dataset(tmp_path / "t" / "dataset"), _dataset(tmp_path / "j" / "dataset")
    got = _run(t_prep_cli.main, ["--mode", mode, "--dataset-dir", str(tdir)], capsys)
    want = _run(j_prep_cli.main, ["--mode", mode, "--dataset-dir", str(jdir)], capsys)
    assert got.replace(str(tdir), "<d>") == want.replace(str(jdir), "<d>").replace("(tpu rebuild)", "(PyTorch port)")
    assert _files(tdir) == _files(jdir)
    if mode in ("combine", "all"):
        assert len((tdir / "combined" / "wav.scp").read_text().splitlines()) == 6
    if mode in ("instruct", "all"):
        assert "四川话" in (tdir / "sichuan" / "instruct").read_text(encoding="utf-8")


@pytest.mark.parametrize("cli", ["extract_embedding", "extract_speech_token"])
def test_extraction_cli_defaults_to_cuda(corpus, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is served")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    out = subprocess.run([sys.executable, "-m", f"fangyan_tts_torch.cli.{cli}", "--dir", str(corpus)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not (corpus / "utt2embedding.pt").exists() and not (corpus / "utt2speech_token.pt").exists()
