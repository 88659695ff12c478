"""The dataset-generation CLIs of fangyan_tts_torch against the JAX package's,
on the CPU:

- `cli.generate_dialect_dataset --dry-run` in both packages on one input
  directory (an aishell transcript and two dialect text files): byte-equal
  dataset_cache.json, wav.scp, text, utt2spk and spk2utt, with each output
  directory's own path replaced. Python's `random` is seeded identically
  before each package's prepare_dataset, which samples the transcript with
  an unseeded random.sample.
- `--backend cuda --device cpu` against the JAX package's `--backend tpu` on
  the tiny model directory of tests/test_torch_api.py and a prompt wav: the
  same file set, equal lengths, each wav within 1e-3 (PARITY.json's wav
  limit); a rerun writes nothing. Both packages' CLIs load
  `CosyVoice3(model_dir)` in bf16 by default; here both loads are made
  float32 (the comparable precision: bf16 rounds differently in XLA and in
  torch), and both build the tiny CAM++ / S3 through the makers that
  tests/test_torch_api.py replaces. Both packages decode with a bf16 KV
  cache, so the texts are ones whose greedy decodes meet no near-tie
  (tests/test_torch_api.py's docstring says why): with this model, prompt
  and instruct, "再来一句。", "今天天气不错。", "Good.", "好的。" and
  "提示文本。" part in their tokens or by about 2e-3 in their wavs, and
  the NO_TIE_TEXTS agree to about 1e-5.
- the DashScope / Aliyun / ESD / emotion CLIs in --dry-run (or on the tree
  they index), and the Doubao smoke test on a stubbed `requests`: their
  index files byte-equal to the JAX package's.
"""

import base64
import functools
import json
import random
import sys
import types
import warnings

import numpy as np
import pytest

import fangyan_tts_torch.api as tapi
import fangyan_tts_tpu.api as japi
from test_torch_api import _jax_makers, _torch_makers, model_dir  # noqa: F401 (a fixture)

WAV_ATOL = 1e-3
NO_TIE_TEXTS = ["你好。", "吃饭了吗。", "你好，世界。"]
KALDI = ("wav.scp", "text", "utt2spk", "spk2utt")
AISHELL = ["BAC009S0002W0122 而 对 楼市 成交 抑制 作用 最 大 的 限 购",
           "BAC009S0002W0123 也 成为 地方 政府 的 眼中 钉",
           "BAC009S0002W0124 自 六月 底 呼和浩特 市 率先 宣布 取消 限 购 后"]


@pytest.fixture()
def input_dir(tmp_path):
    d = tmp_path / "input"
    d.mkdir()
    (d / "aishell_transcript_v0.8.txt").write_text("\n".join(AISHELL) + "\n", encoding="utf-8")
    (d / "hunan.txt").write_text("你好。\n\n吃饭了吗。\n", encoding="utf-8")
    (d / "henan.txt").write_text("中不中。\n", encoding="utf-8")
    return d


def _tree(root, prefix=None) -> dict:
    """{relative path: bytes} of every file under root, with the root's own
    absolute path replaced in the bytes."""
    prefix = str(root.resolve()) if prefix is None else prefix
    return {str(p.relative_to(root)): p.read_bytes().replace(prefix.encode(), b"<OUT>")
            for p in sorted(root.rglob("*")) if p.is_file() and p.suffix != ".wav"}


def _run_both(tmp_path, jmain, tmain, jargs, targs, seed: int = 0):
    """Run each package's main with its own output directory (random seeded
    the same before each); returns the two output directories."""
    outs = []
    for name, main, args in (("jax", jmain, jargs), ("port", tmain, targs)):
        out = tmp_path / f"out_{name}"
        random.seed(seed)
        main([*args, "--output-dir", str(out)])
        outs.append(out)
    return outs


@pytest.mark.parametrize("mode, jbackend, tbackend", [
    ("all", "volcengine", "volcengine"), ("hunan", "tpu", "cuda"), ("henan", "volcengine", "volcengine")])
def test_dialect_dry_run_index_equal(tmp_path, input_dir, mode, jbackend, tbackend):
    from fangyan_tts_torch.cli import generate_dialect_dataset as tg
    from fangyan_tts_tpu.cli import generate_dialect_dataset as jg

    common = ["--dry-run", "--mode", mode, "--input-dir", str(input_dir)]
    jo, to = _run_both(tmp_path, jg.main, tg.main, [*common, "--backend", jbackend], [*common, "--backend", tbackend])
    want, got = _tree(jo), _tree(to)
    assert sorted(got) == sorted(want) and "dataset_cache.json" in got
    dialects = list(tg.DIALECT_CONFIG) if mode == "all" else [mode]
    assert sorted(got) == sorted(["dataset_cache.json"] + [f"{d}/{f}" for d in dialects for f in KALDI])
    for k in want:
        assert got[k] == want[k], k
    cache = json.loads((to / "dataset_cache.json").read_text(encoding="utf-8"))
    assert len(cache["hunan"]) == len(AISHELL) + 2 and len(cache["henan"]) == len(AISHELL) + 1
    ext = b".wav" if tbackend == "cuda" else b".mp3"
    assert all(line.endswith(ext) for line in got[f"{mode if mode != 'all' else 'hunan'}/wav.scp"].split(b"\n")
               if line)
    # a rerun reads the cache: the same index, whatever random does now
    random.seed(99)
    tg.main([*common, "--backend", tbackend, "--output-dir", str(to)])
    assert _tree(to) == got


def test_dialect_backend_names():
    """The JAX package's `--backend tpu` is the port's `--backend cuda`."""
    from fangyan_tts_torch.cli import generate_dialect_dataset as tg

    with pytest.raises(SystemExit):
        tg.main(["--backend", "tpu", "--dry-run"])


@pytest.fixture()
def float32_apis(monkeypatch):
    """Both packages' CosyVoice3 loads made float32, with the tiny CAM++ /
    S3 makers."""
    monkeypatch.setattr(japi, "make_campplus_fn", _jax_makers()[0])
    monkeypatch.setattr(japi, "make_s3_fn", _jax_makers()[1])
    monkeypatch.setattr(tapi, "make_campplus_fn", _torch_makers()[0])
    monkeypatch.setattr(tapi, "make_s3_fn", _torch_makers()[1])
    monkeypatch.setattr(japi, "CosyVoice3", functools.partial(japi.CosyVoice3, fp16=False))
    monkeypatch.setattr(tapi, "CosyVoice3", functools.partial(tapi.CosyVoice3, fp16=False))


def test_cuda_backend_on_cpu_matches_tpu_backend(tmp_path, model_dir, float32_apis):  # noqa: F811
    from fangyan_tts_torch.cli import generate_dialect_dataset as tg
    from fangyan_tts_tpu.cli import generate_dialect_dataset as jg

    inp = tmp_path / "input"
    inp.mkdir()
    (inp / "hunan.txt").write_text("".join(t + "\n" for t in NO_TIE_TEXTS), encoding="utf-8")
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    (prompts / "hunan.wav").write_bytes((model_dir / "prompt.wav").read_bytes())
    common = ["--mode", "hunan", "--input-dir", str(inp), "--model-dir", str(model_dir),
              "--prompt-wav-dir", str(prompts)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jo, to = _run_both(tmp_path, jg.main, tg.main, [*common, "--backend", "tpu"],
                           [*common, "--backend", "cuda", "--device", "cpu"])
    jw, tw = sorted((jo / "hunan" / "wavs").glob("*.wav")), sorted((to / "hunan" / "wavs").glob("*.wav"))
    assert [p.name for p in tw] == [p.name for p in jw] == [f"hunan_{i:05d}.wav" for i in range(len(NO_TIE_TEXTS))]
    assert _tree(to) == _tree(jo)
    from fangyan_tts_torch.data.audio import read_wav

    for a, b in zip(tw, jw):
        got, sr = read_wav(a)
        want, sr_j = read_wav(b)
        assert sr == sr_j == 24000 and got.shape == want.shape and len(want) % 480 == 0
        np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)
        assert np.abs(want).max() > 1e-2
    # a rerun skips the wavs that exist: nothing synthesized, no file rewritten
    mtimes = [p.stat().st_mtime_ns for p in tw]
    stats = tg.main([*common, "--backend", "cuda", "--device", "cpu", "--output-dir", str(to)])
    assert stats["utts"] == 0 and stats["batches"] == 0
    assert [p.stat().st_mtime_ns for p in tw] == mtimes


def test_dashscope_dry_run_index_equal(tmp_path, input_dir):
    from fangyan_tts_torch.cli import generate_dialect_dataset_dashscope as t
    from fangyan_tts_tpu.cli import generate_dialect_dataset_dashscope as j

    args = ["--dry-run", "--input-dir", str(input_dir), "--samples-per-dialect", "2"]
    jo, to = _run_both(tmp_path, j.main, t.main, args, args)
    want, got = _tree(jo), _tree(to)
    assert got == want and "minnan/instruct.txt" in got and b"<OUT>/minnan/wavs/minnan_00001.wav" in got["minnan/wav.scp"]


def test_aliyun_dry_run_index_equal(tmp_path, input_dir):
    from fangyan_tts_torch.cli import generate_emotional_dataset_aliyun as t
    from fangyan_tts_tpu.cli import generate_emotional_dataset_aliyun as j

    args = ["--dry-run", "--input-dir", str(input_dir), "--samples-per-emotion", "3", "--emotions", "happy", "sad"]
    jo, to = _run_both(tmp_path, j.main, t.main, args, args)
    want, got = _tree(jo), _tree(to)
    assert got == want and sorted({k.split("/")[0] for k in got}) == ["happy", "sad"]
    assert t._pop_signature({"b": "2", "a": "x y"}, "s") == j._pop_signature({"b": "2", "a": "x y"}, "s")


def test_esd_index_equal(tmp_path):
    from fangyan_tts_torch.cli import generate_esd_dataset as t
    from fangyan_tts_tpu.cli import generate_esd_dataset as j

    esd = tmp_path / "ESD"
    for spk in ("0001", "0002"):
        (esd / spk).mkdir(parents=True)
        (esd / spk / f"{spk}.txt").write_text(f"{spk}_000351\t打嗝。\tHappy\n{spk}_000701\t好的。\tSurprise\n",
                                             encoding="utf-8")
        for emo, utt in (("Happy", "000351"), ("Surprise", "000701"), ("Neutral", "000001")):
            (esd / spk / emo).mkdir()
            (esd / spk / emo / f"{spk}_{utt}.wav").write_bytes(b"RIFF")
    args = ["--esd-dir", str(esd)]
    jo, to = _run_both(tmp_path, j.main, t.main, args, args)
    want, got = _tree(jo, str(esd.resolve())), _tree(to, str(esd.resolve()))
    assert got == want and got["wav.scp"].count(b"\n") == 6


def test_emotion_index_equal(tmp_path):
    from fangyan_tts_torch.cli import generate_emotion_dataset as t
    from fangyan_tts_tpu.cli import generate_emotion_dataset as j

    src = tmp_path / "casia"
    for emo in ("happy", "neutral", "angry", "surprise"):
        (src / "liuchang" / emo).mkdir(parents=True)
        for i in range(2):
            (src / "liuchang" / emo / f"{emo}_{i}.wav").write_bytes(b"RIFF")
    args = ["--source-dirs", str(src), "--asr", "none"]
    jo, to = _run_both(tmp_path, j.main, t.main, args, args)
    want, got = _tree(jo, str(src.resolve())), _tree(to, str(src.resolve()))
    assert got == want and got["wav.scp"].count(b"\n") == 6
    assert got["instruct_positive.txt"].count(b"\n") == 4 and got["instruct_neutral.txt"].count(b"\n") == 2


def test_doubao_on_stubbed_requests(tmp_path, monkeypatch):
    from fangyan_tts_torch.cli import doubao_tts as t
    from fangyan_tts_tpu.cli import doubao_tts as j

    monkeypatch.chdir(tmp_path)  # load_api_configs reads ./.env
    monkeypatch.setenv("VOLC_APPID", "app")
    monkeypatch.setenv("VOLC_TOKEN", "tok")
    sent = []

    class _Resp:
        def json(self):
            return {"data": base64.b64encode(b"ID3-mp3-bytes").decode()}

    def post(url, json=None, headers=None, timeout=None):
        sent.append((url, {k: v for k, v in json.items() if k != "request"}, json["request"]["text"], headers))
        return _Resp()

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(post=post))
    for name, main in (("jax", j.main), ("port", t.main)):
        main(["--text", "测试。", "--output", str(tmp_path / f"{name}.mp3")])
    assert (tmp_path / "port.mp3").read_bytes() == (tmp_path / "jax.mp3").read_bytes() == b"ID3-mp3-bytes"
    assert sent[0] == sent[1] and sent[0][3] == {"Authorization": "Bearer;tok"}
    monkeypatch.delenv("VOLC_APPID")
    with pytest.raises(SystemExit):
        t.main(["--output", str(tmp_path / "none.mp3")])
