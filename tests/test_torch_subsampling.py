"""fangyan_tts_torch/models/subsampling.py against the JAX package's
models/subsampling.py, on the CPU, in float32: each subsampler (the
embedding, Conv1dSubsampling2, Conv2dSubsampling4/6/8) with every
positional-encoding kind, its parameters a reference-layout state dict (the
port's modules carry the reference's names) made from numpy and passed
through the JAX package's converters, on numpy-seeded inputs: outputs and
position encodings within 1e-5, the cut masks equal. The port's copies of
the converters give the JAX converters' trees, and both position tables
equal the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fangyan_tts_torch.models.subsampling as tsub
import fangyan_tts_tpu.models.subsampling as jsub
import torch_port_util  # noqa: F401  (one torch CPU thread per worker)

ATOL = 1e-5
IDIM, ODIM, T, B = 40, 32, 37, 2
KINDS = ("abs", "rel", "whisper", "learnable", "none")


def _fill(module: torch.nn.Module, seed: int) -> dict:
    """Numpy N(0, 1/fan_in) weights (N(0, 0.1) biases, N(0, 0.02) pe) into
    the module; returns its state dict as numpy (the reference layout)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        fan_in = int(np.prod(v.shape[1:])) if v.dim() >= 2 and not k.endswith("pe") else 1
        scale = 0.02 if k.endswith("pe") else (1 / np.sqrt(fan_in) if v.dim() >= 2 else 0.1)
        sd[k] = (scale * rng.standard_normal(tuple(v.shape))).astype(np.float32)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd


def _pos_params(sd: dict, kind: str) -> dict:
    return {"pos_enc": {"pe": sd["pos_enc.pe"]}} if kind == "learnable" else {}


def _compare(tmod, jmod, params, x: np.ndarray, offset: int) -> None:
    mask = np.ones((B, 1, x.shape[1]), bool)
    mask[1, :, x.shape[1] - 5:] = False
    with torch.no_grad():
        th, tpos, tmask = tmod(torch.from_numpy(x), torch.from_numpy(mask), offset)
    jh, jpos, jmask = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), offset)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tpos.detach().numpy(), np.asarray(jpos), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert np.abs(np.asarray(jh)).max() > 0.1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,n_convs,out", [("Conv2dSubsampling4", 2, "out"), ("Conv2dSubsampling6", 2, "linear"),
                                              ("Conv2dSubsampling8", 3, "linear")])
def test_conv2d_subsampling(name, n_convs, out, kind):
    tmod = getattr(tsub, name)(IDIM, ODIM, kind).eval()
    sd = _fill(tmod, 1 + n_convs)
    params = jsub.conv2d_subsampling_params_from_reference(sd, n_convs, out)
    port = tsub.conv2d_subsampling_params_from_reference(sd, n_convs, out)
    assert jax.tree.all(jax.tree.map(np.array_equal, port, params))
    x = np.random.default_rng(5).standard_normal((B, T, IDIM)).astype(np.float32)
    _compare(tmod, getattr(jsub, name)(IDIM, ODIM, kind), {**params, **_pos_params(sd, kind)}, x, 3)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t", [T, T + 1])
def test_conv1d_subsampling2(kind, t):
    tmod = tsub.Conv1dSubsampling2(IDIM, ODIM, kind).eval()
    sd = _fill(tmod, 7)
    params = jsub.conv1d_subsampling2_params_from_reference(sd)
    assert jax.tree.all(jax.tree.map(np.array_equal, tsub.conv1d_subsampling2_params_from_reference(sd), params))
    x = np.random.default_rng(t).standard_normal((B, t, IDIM)).astype(np.float32)
    _compare(tmod, jsub.Conv1dSubsampling2(IDIM, ODIM, kind), {**params, **_pos_params(sd, kind)}, x, 0)


@pytest.mark.parametrize("kind", KINDS)
def test_embedding_no_subsampling(kind):
    tmod = tsub.EmbeddingNoSubsampling(50, ODIM, kind).eval()
    sd = _fill(tmod, 9)
    ids = np.random.default_rng(9).integers(0, 50, (B, T)).astype(np.int32)
    mask = np.ones((B, 1, T), bool)
    with torch.no_grad():
        th, tpos, tmask = tmod(torch.from_numpy(ids).long(), torch.from_numpy(mask), 2)
    params = {"embed": {"embedding": sd["embed.weight"]}, **_pos_params(sd, kind)}
    jh, jpos, _ = jsub.EmbeddingNoSubsampling(50, ODIM, kind).apply({"params": params}, jnp.asarray(ids),
                                                                   jnp.asarray(mask), 2)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tpos.detach().numpy(), np.asarray(jpos), rtol=0, atol=ATOL)
    assert torch.equal(tmask, torch.from_numpy(mask))


@pytest.mark.parametrize("max_len,d", [(100, 32), (5000, 256)])
def test_position_tables(max_len, d):
    np.testing.assert_array_equal(tsub.sincos_pos_table(max_len, d), jsub.sincos_pos_table(max_len, d))
    np.testing.assert_array_equal(tsub.whisper_pos_table(max_len, d), jsub.whisper_pos_table(max_len, d))


def test_reference_names():
    """The torch parameter names of the reference's modules."""
    assert set(tsub.Conv2dSubsampling4(IDIM, ODIM).state_dict()) == {
        "conv.0.weight", "conv.0.bias", "conv.2.weight", "conv.2.bias", "out.0.weight", "out.0.bias"}
    assert set(tsub.Conv2dSubsampling8(IDIM, ODIM, "learnable").state_dict()) == {
        "conv.0.weight", "conv.0.bias", "conv.2.weight", "conv.2.bias", "conv.4.weight", "conv.4.bias",
        "linear.weight", "linear.bias", "pos_enc.pe"}
    assert set(tsub.Conv1dSubsampling2(IDIM, ODIM).state_dict()) == {
        "conv.0.weight", "conv.0.bias", "conv.2.weight", "conv.2.bias"}
