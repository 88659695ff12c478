"""The port's ONNX reader / writer (data/onnx_proto.py) and ONNX converters
(models/convert.campplus_params_from_onnx / s3_params_from_onnx) against the
JAX package's, on graphs written by `save_model` from the tests/oracles
modules' state dicts (no ONNX file is in the repository):
- a graph written by either package's writer is byte-equal to the other's
  and reads back with the same initializers, nodes and attributes;
- each converter gives the JAX converter's tree leaf for leaf (same paths,
  shapes, dtypes, values) and the same derived S3 hyperparameters;
- the port's module loaded from that tree gives the oracle's output: the
  x-vector within CAM++'s atol 2e-4 / rtol 2e-3
  (tests/test_campplus_parity.py), S3 codes and code lengths bit-equal;
- graphs whose initializers are not state-dict-named, or whose dense-layer
  count is not the one asked for, are refused by both."""

import numpy as np
import pytest
import torch

from fangyan_tts_torch.data import onnx_proto as tproto
from fangyan_tts_torch.infer.frontend import make_campplus_fn, make_s3_fn
from fangyan_tts_torch.models import convert as tconvert
from fangyan_tts_tpu.data import onnx_proto as jproto
from fangyan_tts_tpu.models import convert as jconvert
from torch_port_util import FE_CAMP, FE_S3, campplus_kwargs, campplus_oracle, s3_kwargs, s3_oracle

XVEC_ATOL, XVEC_RTOL = 2e-4, 2e-3


def _graph(weights: dict) -> dict:
    return dict(nodes=[("Gemm", ["x", "a.weight", "a.bias"], ["y"], {"transB": 1, "alpha": 1.0}),
                       ("Conv", ["y", "c.weight"], ["z"], {"strides": [2], "pads": [1, 1], "group": 2})],
                initializers=weights, inputs=["x"], outputs=["z"])


def test_writer_reader_roundtrip(tmp_path):
    w = {"a.weight": np.arange(12, dtype=np.float32).reshape(3, 4), "a.bias": np.ones(3, np.float32),
         "c.weight": np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 2, 3), "ids": np.asarray([5, -2], np.int64),
         "n": np.asarray(7, np.int64)}
    tproto.save_model(str(tmp_path / "t.onnx"), **_graph(w))
    jproto.save_model(str(tmp_path / "j.onnx"), **_graph(w))
    assert (tmp_path / "t.onnx").read_bytes() == (tmp_path / "j.onnx").read_bytes()
    for path in ("t.onnx", "j.onnx"):
        g, jg = tproto.load_graph(str(tmp_path / path)), jproto.load_graph(str(tmp_path / path))
        assert g.inputs == jg.inputs == ["x"] and g.outputs == jg.outputs == ["z"]
        got = g.weights()
        assert sorted(got) == sorted(w)
        for k in w:
            assert got[k].dtype == w[k].dtype and got[k].shape == w[k].shape, k
            np.testing.assert_array_equal(got[k], w[k])
        gemm, conv = g.nodes
        assert (gemm.op_type, gemm.inputs, gemm.outputs) == ("Gemm", ["x", "a.weight", "a.bias"], ["y"])
        assert gemm.attr("transB") == 1 and gemm.attr("alpha") == pytest.approx(1.0)
        assert conv.attr("strides") == [2] and conv.attr("pads") == [1, 1] and conv.attr("group") == 2
    # bytes, not a path, are read too
    assert sorted(tproto.load_graph((tmp_path / "t.onnx").read_bytes()).weights()) == sorted(w)


def _save_state(path, module, output: str) -> None:
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    tproto.save_model(str(path), nodes=[], initializers=sd, inputs=["feats"], outputs=[output])


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_campplus_from_onnx(tmp_path):
    oracle = campplus_oracle(FE_CAMP, 41)
    _save_state(tmp_path / "campplus.onnx", oracle, "embedding")
    blocks = FE_CAMP["block_layers"]
    params = tconvert.campplus_params_from_onnx(str(tmp_path / "campplus.onnx"), blocks)
    _assert_trees_equal(params, jconvert.campplus_params_from_onnx(str(tmp_path / "campplus.onnx"), blocks))
    _, tkw = campplus_kwargs(FE_CAMP)
    fn = make_campplus_fn(params, device="cpu", dtype=torch.float32, **tkw)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 157, 80)).astype(np.float32))
    with torch.no_grad():
        want = oracle(x).numpy()
    np.testing.assert_allclose(fn(x).numpy(), want, atol=XVEC_ATOL, rtol=XVEC_RTOL)
    for mod in (tconvert, jconvert):  # the full-size default asks for 52 dense layers
        with pytest.raises(ValueError, match="dense layers"):
            mod.campplus_params_from_onnx(str(tmp_path / "campplus.onnx"))


def test_s3_from_onnx(tmp_path):
    oracle = s3_oracle(FE_S3, 42)
    _save_state(tmp_path / "speech_tokenizer_v3.onnx", oracle, "codes")
    params, hyper = tconvert.s3_params_from_onnx(str(tmp_path / "speech_tokenizer_v3.onnx"))
    jparams, jhyper = jconvert.s3_params_from_onnx(str(tmp_path / "speech_tokenizer_v3.onnx"))
    _assert_trees_equal(params, jparams)
    assert hyper == jhyper == {"dim": 32, "n_mels": 128, "layers": 2, "fsmn_kernel": 7}
    kw = s3_kwargs(FE_S3)
    assert {k: kw[k] for k in hyper} == hyper
    fn = make_s3_fn(params, device="cpu", dtype=torch.float32, **kw)
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 128, 60)).astype(np.float32))
    mel_len = torch.tensor([60, 41, 9])
    with torch.no_grad():
        want_codes, want_len = oracle.quantize(mel, mel_len)
    codes, code_len = fn(mel, mel_len)
    np.testing.assert_array_equal(code_len.numpy(), want_len.numpy())
    for b, n in enumerate(want_len.tolist()):
        np.testing.assert_array_equal(codes[b, :n].numpy(), want_codes[b, :n].numpy())
    assert len(np.unique(codes[0].numpy())) > 3


@pytest.mark.parametrize("kind", ["campplus", "s3"])
def test_folded_graph_refused(tmp_path, kind):
    """A constant-folded export renames its initializers (onnx::Conv_*)."""
    oracle = campplus_oracle(FE_CAMP, 43) if kind == "campplus" else s3_oracle(FE_S3, 44)
    sd = {f"onnx::Conv_{i}": v.numpy() for i, v in enumerate(oracle.state_dict().values())}
    path = str(tmp_path / f"{kind}.onnx")
    tproto.save_model(path, nodes=[], initializers=sd, inputs=["feats"], outputs=["out"])
    name = "campplus_params_from_onnx" if kind == "campplus" else "s3_params_from_onnx"
    for mod in (tconvert, jconvert):
        with pytest.raises(ValueError, match="state-dict-named"):
            getattr(mod, name)(path)
