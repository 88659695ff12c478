"""fangyan_tts_torch.ops.decode_attention (CPU: its plain version) against
the JAX package's `carry_decode_attention` and the Pallas
`fused_decode_attention` in interpret mode, bf16. Mirrors
tests/test_decode_attention.py: output within atol 2e-2, cache writes
bit-equal, the write on the clamped row of the chosen layer only, each head
seeing only its own KV group."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch CPU thread per worker)
from fangyan_tts_torch.ops import decode_attention as tda
from fangyan_tts_tpu.ops.decode_attention import carry_decode_attention, fused_decode_attention

L, S, KV, HD, QH = 3, 64, 2, 64, 14


def _inputs(seed, b):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, QH, HD), (b, KV, HD), (b, KV, HD), (L, b, S, KV, HD), (L, b, S, KV, HD))]
    return [jnp.asarray(a, jnp.bfloat16) for a in arrs]


def _torch(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _run_port(q, kn, vn, ck, cv, idx, bias, layer):
    ck_t, cv_t = _torch(ck), _torch(cv)
    out = tda.decode_attention(_torch(q), _torch(kn), _torch(vn), ck_t, cv_t,
                               torch.from_numpy(np.asarray(idx, np.int32)),
                               torch.from_numpy(np.asarray(bias, np.float32)), layer)
    return out.float().numpy(), ck_t.float().numpy(), cv_t.float().numpy()


@pytest.mark.parametrize("b", [1, 4])
def test_plain_matches_jax(b):
    q, kn, vn, ck, cv = _inputs(0, b)
    idx = np.asarray(np.random.default_rng(1).integers(0, S, (b,)), np.int32)
    bias = np.where(np.arange(S)[None, :] < (idx + 1)[:, None], 0.0, -1e10).astype(np.float32)
    for layer in (0, L - 1):
        out, ck_t, cv_t = _run_port(q, kn, vn, ck, cv, idx, bias, layer)
        o1, ck1, cv1 = carry_decode_attention(q, kn, vn, ck, cv, jnp.asarray(idx), jnp.asarray(bias), layer)
        o2, ck2, cv2 = fused_decode_attention(q, kn, vn, ck, cv, jnp.asarray(idx), jnp.asarray(bias),
                                              jnp.asarray(layer), interpret=True)
        for o in (o1, o2):
            np.testing.assert_allclose(out, np.asarray(o, np.float32), rtol=0, atol=2e-2)
        for c_t, c1, c2 in ((ck_t, ck1, ck2), (cv_t, cv1, cv2)):
            np.testing.assert_array_equal(c_t, np.asarray(c1, np.float32))
            np.testing.assert_array_equal(c_t, np.asarray(c2, np.float32))


@pytest.mark.parametrize("raw", [S - 1, S + 7])
def test_clamped_write_lands_on_chosen_layer(raw):
    b = 2
    q, kn, vn, ck, cv = _inputs(2, b)
    idx = np.full((b,), raw, np.int32)
    bias = np.zeros((b, S), np.float32)
    out, ck_t, _ = _run_port(q, kn, vn, ck, cv, idx, bias, 1)
    o1, ck1, _ = carry_decode_attention(q, kn, vn, ck, cv, jnp.asarray(idx), jnp.asarray(bias), 1)
    np.testing.assert_allclose(out, np.asarray(o1, np.float32), rtol=0, atol=2e-2)
    np.testing.assert_array_equal(ck_t, np.asarray(ck1, np.float32))
    before = np.asarray(ck, np.float32)
    np.testing.assert_array_equal(ck_t[1, :, S - 1], np.asarray(kn, np.float32))
    np.testing.assert_array_equal(ck_t[1, :, : S - 1], before[1, :, : S - 1])
    np.testing.assert_array_equal(ck_t[0], before[0])
    np.testing.assert_array_equal(ck_t[2], before[2])


def test_gqa_group_isolation():
    """Perturbing KV group 1 must leave heads 0..6 unchanged."""
    q, kn, vn, ck, cv = _inputs(3, 1)
    idx = np.asarray([S // 2], np.int32)
    bias = np.zeros((1, S), np.float32)
    o1, _, _ = _run_port(q, kn, vn, ck, cv, idx, bias, 0)
    ck_p, cv_p = ck.at[0, :, :, 1, :].add(1.0), cv.at[0, :, :, 1, :].add(1.0)
    o2, _, _ = _run_port(q, kn, vn, ck_p, cv_p, idx, bias, 0)
    gpk = QH // KV
    np.testing.assert_array_equal(o1[:, :gpk], o2[:, :gpk])
    assert not np.array_equal(o1[:, gpk:], o2[:, gpk:])


def test_cpu_calls_do_not_count_as_launches():
    q, kn, vn, ck, cv = _inputs(4, 1)
    before = tda.launches
    _run_port(q, kn, vn, ck, cv, np.asarray([3], np.int32), np.zeros((1, S), np.float32), 0)
    assert tda.launches == before
