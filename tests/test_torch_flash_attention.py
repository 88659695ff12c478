"""fangyan_tts_torch.ops.flash_attention (CPU: its plain version) against
the Pallas `chunk_flash_attention` in interpret mode and against dense
attention under ops/masks.chunk_attn_mask, float32, ragged mel_len.
Contract of tests/test_flash_attention.py: atol 2e-5, rtol 1e-4 on the
valid rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch CPU thread per worker)
from fangyan_tts_torch.ops import device as tdevice
from fangyan_tts_torch.ops import flash_attention as tfa
from fangyan_tts_tpu.ops.flash_attention import chunk_flash_attention
from fangyan_tts_tpu.ops.masks import chunk_attn_mask


def _dense(q, k, v, mel_len, chunk):
    d = q.shape[-1]
    mask = chunk_attn_mask(mel_len, q.shape[2], chunk)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    s = jnp.where(mask[:, None], s, -1e30)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


@pytest.mark.parametrize("chunk,l,mel", [(0, 48, (48, 30)), (10, 64, (64, 37)), (10, 40, (23, 40))])
def test_plain_matches_pallas_and_dense(chunk, l, mel):
    rng = np.random.default_rng(chunk + l)
    b, h, d = 2, 3, 64
    q, k, v = [(rng.standard_normal((b, h, l, d)) * 0.5).astype(np.float32) for _ in range(3)]
    mel_len = np.asarray(mel, np.int32)
    got = tfa.chunk_flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mel_len), chunk).numpy()
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mel_len))
    pallas = np.asarray(chunk_flash_attention(jq, jk, jv, jm, chunk=chunk, block_q=16, block_k=16, interpret=True))
    dense = np.asarray(_dense(jq, jk, jv, jm, chunk))
    for bi in range(b):
        n = mel[bi]
        np.testing.assert_allclose(got[bi, :, :n], pallas[bi, :, :n], atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(got[bi, :, :n], dense[bi, :, :n], atol=2e-5, rtol=1e-4)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("chunk,l,mel", [(0, 48, (48, 30)), (10, 64, (64, 37)), (10, 40, (23, 40))])
def test_strided_views_equal_contiguous(chunk, l, mel):
    """The DiT hands the kernel (B, H, L, D) views of its (B, L, H*D)
    projections and of the (B, L, 3*H*D) qkv buffer, without copies: the
    function on those views equals the same call on contiguous copies."""
    rng = np.random.default_rng(chunk + l + 1)
    b, h, d = 2, 3, 64
    q_bl, k_bl = (torch.from_numpy(rng.standard_normal((b, l, h * d)).astype(np.float32)) for _ in range(2))
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * h * d)).astype(np.float32))
    heads = lambda t: t.reshape(b, l, h, d).transpose(1, 2)  # noqa: E731
    q, k, v = heads(q_bl), heads(k_bl), heads(qkv[..., 2 * h * d:])
    assert not (q.is_contiguous() or v.is_contiguous()) and v.stride()[2] == 3 * h * d
    mel_len = torch.tensor(mel, dtype=torch.int32)
    got = tfa.chunk_flash_attention(q, k, v, mel_len, chunk)
    want = tfa.chunk_flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), mel_len, chunk)
    assert got.shape == (b, h, l, d)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("chunk", [0, 50])
@pytest.mark.parametrize("l,mel", [(129, (129, 0, 77)), (300, (300, 0, 173))])
def test_plain_matches_pallas_at_f32_tile_edges(l, mel, chunk):
    """The function the CUDA float32 route is held to on the card
    (chunk_flash_attention_plain in float32) against the Pallas kernel in
    interpret mode, float32, at lengths that cross the route's 128-row query
    block (L = 129: one row past it; L = 300: a 50-frame chunk boundary,
    row 150, inside the second block) with ragged mel_len including 0. The
    file's contract: atol 2e-5, rtol 1e-4 on the valid rows; every value
    finite."""
    rng = np.random.default_rng(l + chunk)
    b, h, d = len(mel), 2, 64
    q, k, v = [(rng.standard_normal((b, h, l, d)) * 0.5).astype(np.float32) for _ in range(3)]
    mel_len = np.asarray(mel, np.int32)
    got = tfa.chunk_flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mel_len),
                                          chunk).numpy()
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mel_len))
    pallas = np.asarray(chunk_flash_attention(jq, jk, jv, jm, chunk=chunk, block_q=64, block_k=64, interpret=True))
    for bi in range(b):
        n = mel[bi]
        np.testing.assert_allclose(got[bi, :, :n], pallas[bi, :, :n], atol=2e-5, rtol=1e-4)
    assert got.dtype == np.float32 and np.isfinite(got).all()


def test_cpu_calls_do_not_count_as_launches():
    x = torch.zeros((1, 1, 8, 64))
    before = tdevice.launches.copy()
    tfa.chunk_flash_attention(x, x, x, torch.tensor([5], dtype=torch.int32), 0)
    assert tdevice.launches == before
