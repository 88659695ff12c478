"""The fine-tune comparison CLIs of fangyan_tts_torch against the JAX
package's, on the CPU, on the tiny model directory of
tests/test_torch_api.py:

- `cli.compare_inference --dialects hunan --num_texts 1` with a fine-tuned
  LLM given as a perturbed `.msgpack` tree and as a reference-layout `.pt`
  state dict (with the epoch / step entries of a training checkpoint): the
  same file set, the original and the fine-tuned wav each within 1e-3 of
  the JAX package's, and the two different from each other. The JAX CLI
  reassigns `llm_params`; the port loads the checkpoint into
  `model.model.llm` by `load_state_dict`.
- `cli.dialect_inference_test` on two dialects and mandarin: each wav
  within 1e-3 of the JAX package's.

Both CLIs load `AutoModel(model_dir)` in bf16 by default; here both
packages' loads are made float32 (tests/test_torch_datagen.py says why).
Both packages decode with a bf16 KV cache (tests/test_torch_api.py's
docstring), so the sentences and perturbations are ones whose greedy
decodes meet no near-tie with this model and prompt. The first sentence of
compare_inference's list does, and so does its fine-tuned decode with the
decoder kernel perturbed by seed 4 at scale 0.05; seeds 1-3, and the second
sentence's original decode, part. Loading the perturbed tree as a model
directory's own LLM gives the same wavs as the swap in both packages, so
where the two packages part it is the near-tie and not the swap.
"""

import functools
import json
import warnings

import numpy as np
import pytest
import torch

import fangyan_tts_torch.api as tapi
import fangyan_tts_tpu.api as japi
from fangyan_tts_torch.cli import compare_inference as tci
from fangyan_tts_torch.cli import dialect_inference_test as tdi
from fangyan_tts_torch.data.audio import read_wav
from fangyan_tts_torch.train.checkpoint import load_params, save_params
from fangyan_tts_tpu.cli import compare_inference as jci
from fangyan_tts_tpu.cli import dialect_inference_test as jdi
from test_torch_api import _jax_makers, _torch_makers, model_dir  # noqa: F401 (a fixture)
from test_torch_eval_tools import reference_llm_sd

WAV_ATOL = 1e-3


@pytest.fixture()
def float32_apis(monkeypatch):
    monkeypatch.setattr(japi, "make_campplus_fn", _jax_makers()[0])
    monkeypatch.setattr(japi, "make_s3_fn", _jax_makers()[1])
    monkeypatch.setattr(tapi, "make_campplus_fn", _torch_makers()[0])
    monkeypatch.setattr(tapi, "make_s3_fn", _torch_makers()[1])
    monkeypatch.setattr(japi, "CosyVoice3", functools.partial(japi.CosyVoice3, fp16=False))
    monkeypatch.setattr(tapi, "CosyVoice3", functools.partial(tapi.CosyVoice3, fp16=False))


def _wavs(d) -> dict:
    return {p.name: read_wav(p)[0] for p in sorted(d.glob("*.wav"))}


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want) and got
    for k, w in want.items():
        assert got[k].shape == w.shape and len(w) % 480 == 0, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=WAV_ATOL, err_msg=k)
        assert np.abs(w).max() > 1e-2


def _perturbed(tree, seed: int = 4, scale: float = 0.05):
    """The tree with its LLM decoder's kernel scaled by 1 + scale * N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = dict(tree)
    dec = np.asarray(tree["llm_decoder"]["kernel"])
    out["llm_decoder"] = dict(tree["llm_decoder"], kernel=(dec * (1 + scale * rng.standard_normal(dec.shape))).astype(
        np.float32))
    return out


@pytest.mark.parametrize("kind", ["msgpack", "pt"])
def test_compare_inference(tmp_path, model_dir, float32_apis, kind):  # noqa: F811
    tree = _perturbed(load_params(model_dir / "llm.msgpack"))
    if kind == "msgpack":
        ft = tmp_path / "ft.msgpack"
        save_params(ft, tree)
    else:
        ft = tmp_path / "ft.pt"
        cfg = tapi.config_from_dict(json.loads((model_dir / "config.json").read_text()))
        torch.save(reference_llm_sd(tree, cfg.llm), ft)
    args = ["--pretrained_dir", str(model_dir), "--finetuned_llm", str(ft), "--prompt_wav",
            str(model_dir / "prompt.wav"), "--dialects", "hunan", "--num_texts", "1"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jci.main([*args, "--output_dir", str(tmp_path / "jax")])
        tci.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    got, want = _wavs(tmp_path / "port"), _wavs(tmp_path / "jax")
    assert sorted(got) == ["hunan_1_finetuned.wav", "hunan_1_original.wav"]
    _same(got, want)
    a, b = got["hunan_1_original.wav"], got["hunan_1_finetuned.wav"]
    assert a.shape != b.shape or np.abs(a - b).max() > 1e-2


def test_dialect_inference_test(tmp_path, model_dir, float32_apis, monkeypatch):  # noqa: F811
    """Two dialects and mandarin: both CLIs' DIALECT_DISPLAY cut to the same
    two (neither CLI has a flag for a subset)."""
    two = {k: tci.DIALECT_DISPLAY[k] for k in ("hunan", "henan")}
    monkeypatch.setattr(jdi, "DIALECT_DISPLAY", two)
    monkeypatch.setattr(tdi, "DIALECT_DISPLAY", two)
    args = ["--pretrained_dir", str(model_dir), "--prompt_wav", str(model_dir / "prompt.wav"), "--text", "你好。"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdi.main([*args, "--output_dir", str(tmp_path / "jax")])
        tdi.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    got = _wavs(tmp_path / "port")
    assert sorted(got) == ["henan.wav", "hunan.wav", "mandarin.wav"]
    _same(got, _wavs(tmp_path / "jax"))
