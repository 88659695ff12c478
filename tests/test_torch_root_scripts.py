"""The port's counterparts of the JAX package's root scripts, on the CPU:

- `python -m fangyan_tts_torch.example` on the tiny model directory of
  tests/test_torch_api.py (its tiny CAM++ / S3 built through the makers
  that test replaces) writes every wav file the root example.py writes,
  each a finite, non-empty 24 kHz signal, and saves the speaker. The JAX
  walkthrough's file names come from running its own main on a stub model
  that yields one chunk a call (its code names the files); the port's model
  may yield more segments a call, so the port's names are a superset with
  the same stems.
- `python -m fangyan_tts_torch.webui` without gradio prints the hint, naming
  the port's HTTP server, and exits with code 1 (before it loads a model).
"""

import importlib.util
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import fangyan_tts_torch.api as tapi
from fangyan_tts_torch import example as texample
from fangyan_tts_torch import webui as twebui
from fangyan_tts_torch.data.audio import read_wav
from test_torch_api import _torch_makers, model_dir  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent


class _StubModel:
    """Yields one short chunk per inference call; records nothing."""

    sample_rate = 24000

    def __init__(self, *a, **k):
        pass

    def _one(self, *a, **k):
        yield {"tts_speech": np.zeros(480, np.float32)}

    inference_zero_shot = inference_cross_lingual = inference_instruct2 = inference_vc = _one

    def add_zero_shot_spk(self, *a, **k):
        return True

    def save_spkinfo(self):
        pass


def _jax_example_names(tmp_path, monkeypatch) -> set:
    spec = importlib.util.spec_from_file_location("jax_root_example", REPO / "example.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "AutoModel", _StubModel)
    out = tmp_path / "jax"
    out.mkdir()
    monkeypatch.setattr(sys, "argv", ["example.py", "--model_dir", "x", "--prompt_wav", "p.wav",
                                      "--out_prefix", str(out / "example")])
    mod.main()
    return {p.name for p in out.glob("*.wav")}


def test_example_writes_the_jax_walkthroughs_files(model_dir, tmp_path, monkeypatch):  # noqa: F811
    want = _jax_example_names(tmp_path, monkeypatch)
    assert len(want) == 8, want
    monkeypatch.setattr(tapi, "make_campplus_fn", _torch_makers()[0])
    monkeypatch.setattr(tapi, "make_s3_fn", _torch_makers()[1])
    out = tmp_path / "port"
    out.mkdir()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        texample.main(["--model_dir", str(model_dir), "--prompt_wav", str(model_dir / "prompt.wav"),
                       "--out_prefix", str(out / "example"), "--device", "cpu"])
    got = {p.name for p in out.glob("*.wav")}
    assert want <= got, want - got
    stems = {re.sub(r"_\d+\.wav$|\.wav$", "", n) for n in want}
    assert {re.sub(r"_\d+\.wav$|\.wav$", "", n) for n in got} == stems
    for name in sorted(got):
        wav, sr = read_wav(out / name)
        assert sr == 24000 and wav.size > 0 and np.isfinite(wav).all(), name
    assert (model_dir / "spk2info.pt").exists()


def test_webui_without_gradio_exits_1(model_dir, monkeypatch):  # noqa: F811
    code = ("import sys; sys.modules['gradio'] = None\n"
            "from fangyan_tts_torch import webui\n"
            f"webui.main(['--model_dir', {str(model_dir)!r}, '--device', 'cpu'])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert "gradio is not installed" in r.stderr
    assert "python -m fangyan_tts_torch.runtime.http_server --model_dir <dir>" in r.stderr
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(SystemExit) as e:
        twebui.build_app(None)
    assert e.value.code == 1
