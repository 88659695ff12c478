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


def test_cpu_calls_do_not_count_as_launches():
    x = torch.zeros((1, 1, 8, 64))
    before = tfa.launches
    tfa.chunk_flash_attention(x, x, x, torch.tensor([5], dtype=torch.int32), 0)
    assert tfa.launches == before
