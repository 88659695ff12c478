"""fangyan_tts_torch.ops.decode_attention (CPU: its plain version) against
the JAX package's `carry_decode_attention` and the Pallas
`fused_decode_attention` in interpret mode, bf16. Mirrors
tests/test_decode_attention.py: output within atol 2e-2, cache writes
bit-equal, the write on the clamped row of the chosen layer only, each head
seeing only its own KV group. In float32 (the kernel's float32 route) the
same within atol 1e-5: both sides take float32 products and softmax, so
they differ by a few float32 roundings of outputs of order one. The launch
plans of both routes, their shared memory, and the wrapper's arguments
against each C entry's declaration."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch CPU thread per worker)
from fangyan_tts_torch.ops import _build
from fangyan_tts_torch.ops import decode_attention as tda
from fangyan_tts_torch.ops import device as tdevice
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


def _hold_against_jax(q, kn, vn, ck, cv, idx, bias, layer):
    """The port against carry_decode_attention and the Pallas kernel in
    interpret mode: output atol 2e-2, caches bit-equal. Returns the port's
    output."""
    out, ck_t, cv_t = _run_port(q, kn, vn, ck, cv, idx, bias, layer)
    o1, ck1, cv1 = carry_decode_attention(q, kn, vn, ck, cv, jnp.asarray(idx), jnp.asarray(bias), layer)
    o2, ck2, cv2 = fused_decode_attention(q, kn, vn, ck, cv, jnp.asarray(idx), jnp.asarray(bias),
                                          jnp.asarray(layer), interpret=True)
    for o in (o1, o2):
        np.testing.assert_allclose(out, np.asarray(o, np.float32), rtol=0, atol=2e-2)
    for c_t, c1, c2 in ((ck_t, ck1, ck2), (cv_t, cv1, cv2)):
        np.testing.assert_array_equal(c_t, np.asarray(c1, np.float32))
        np.testing.assert_array_equal(c_t, np.asarray(c2, np.float32))
    return out


def test_left_padded_rows():
    """Batched decode: each row's bias is open on [start_b, idx_b], the first
    open slot differing from row to row (left padding)."""
    b = 4
    q, kn, vn, ck, cv = _inputs(5, b)
    idx = np.asarray([20, 40, 63, S + 3], np.int32)
    start = np.asarray([0, 17, 30, 5], np.int32)
    slot = np.arange(S)[None, :]
    bias = np.where((slot >= start[:, None]) & (slot <= np.minimum(idx, S - 1)[:, None]), 0.0,
                    -1e10).astype(np.float32)
    _hold_against_jax(q, kn, vn, ck, cv, idx, bias, 1)


def test_all_masked_row_beside_a_normal_row():
    """A row with no open slot gives the plain version's answer, the mean of
    V over all S slots, and does not disturb the row beside it."""
    b = 2
    q, kn, vn, ck, cv = _inputs(6, b)
    idx = np.asarray([9, 33], np.int32)
    bias = np.full((b, S), -1e10, np.float32)
    bias[0, : idx[0] + 1] = 0.0
    layer = 2
    out = _hold_against_jax(q, kn, vn, ck, cv, idx, bias, layer)
    _, _, cv_t = _run_port(q, kn, vn, ck, cv, idx, bias, layer)
    v_mean = cv_t[layer, 1].mean(axis=0)  # (KV, hd), after the row write
    np.testing.assert_allclose(out[1].reshape(KV, QH // KV, HD), np.broadcast_to(v_mean[:, None], (KV, QH // KV, HD)),
                               rtol=0, atol=2e-2)


def test_strided_views_equal_contiguous_call():
    """q, k_new and v_new as views of one fused qkv buffer (a batch stride,
    as models/qwen2.py hands them over) give the contiguous call's output
    and cache writes bit for bit."""
    b = 3
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((b, (QH + 2 * KV) * HD + 64)).astype(np.float32)).to(torch.bfloat16)
    q = qkv[:, : QH * HD].reshape(b, QH, HD)
    kn = qkv[:, QH * HD: (QH + KV) * HD].reshape(b, KV, HD)
    vn = qkv[:, (QH + KV) * HD: (QH + 2 * KV) * HD].reshape(b, KV, HD)
    assert not any(t.is_contiguous() for t in (q, kn, vn))
    cache = torch.from_numpy(rng.standard_normal((2, L, b, S, KV, HD)).astype(np.float32)).to(torch.bfloat16)
    idx = torch.tensor([3, 40, S + 1], dtype=torch.int32)
    bias = torch.where(torch.arange(S)[None, :] <= torch.clamp(idx, max=S - 1)[:, None], 0.0, -1e10).float()
    ck1, cv1, ck2, cv2 = cache[0].clone(), cache[1].clone(), cache[0].clone(), cache[1].clone()
    out1 = tda.decode_attention(q, kn, vn, ck1, cv1, idx, bias, 1)
    out2 = tda.decode_attention(q.contiguous(), kn.contiguous(), vn.contiguous(), ck2, cv2, idx, bias, 1)
    assert torch.equal(out1, out2)
    assert torch.equal(ck1, ck2) and torch.equal(cv1, cv2)


@pytest.mark.parametrize("s", [64, 128, 256, 320, 768, 4096, 100, 8200])
@pytest.mark.parametrize("b", [1, 16, 64])
def test_plan_covers_every_slot_once(b, s):
    """The kernel's launch plan: at most MAX_CLUSTER blocks a cluster, runs
    of a multiple of GROUP slots that cover [0, S) once each, and a block's
    shared memory within the card's budget for any group size."""
    n, per = tda.plan(b, s, KV)
    assert 1 <= n <= tda.MAX_CLUSTER
    assert per % tda.GROUP == 0 and per >= tda.GROUP
    runs = [range(r * per, min((r + 1) * per, s)) for r in range(n)]
    assert all(len(run) > 0 for run in runs)
    assert sorted(i for run in runs for i in run) == list(range(s))
    for g in range(1, 9):
        assert tda.smem_bytes(n, per, g) <= tda.SMEM_LIMIT


def test_cpu_calls_do_not_count_as_launches():
    q, kn, vn, ck, cv = _inputs(4, 1)
    before = tdevice.launches.copy()
    _run_port(q, kn, vn, ck, cv, np.asarray([3], np.int32), np.zeros((1, S), np.float32), 0)
    assert tdevice.launches == before


# float32 cases: (rows, write slots, first open slots, layer); a write past S
# is clamped to S - 1, a row whose first open slot is S has none
F32_CASES = {
    "left_padded": (4, [20, 40, 63, S + 3], [0, 17, 30, 5], 1),
    "no_open_slot_and_write_past_s": (4, [0, 33, S - 1, S + 7], [0, 0, 0, S], L - 1),
    "one_row_last_layer": (1, [S // 2], [0], L - 1),
    "first_layer": (2, [5, S - 1], [0, 3], 0),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_plain_float32_matches_jax(case):
    b, idx_list, starts, layer = F32_CASES[case]
    rng = np.random.default_rng(11)
    q, kn, vn, ck, cv = (rng.standard_normal(shape).astype(np.float32) for shape in
                         ((b, QH, HD), (b, KV, HD), (b, KV, HD), (L, b, S, KV, HD), (L, b, S, KV, HD)))
    q *= 2.0  # scores of a few units: the softmax weighs a few slots
    idx = np.asarray(idx_list, np.int32)
    slot = np.arange(S)[None, :]
    bias = np.where((slot >= np.asarray(starts)[:, None]) & (slot <= np.minimum(idx, S - 1)[:, None]), 0.0,
                    -1e10).astype(np.float32)
    t = [torch.from_numpy(a.copy()) for a in (q, kn, vn, ck, cv)]
    out = tda.decode_attention(*t, torch.from_numpy(idx), torch.from_numpy(bias), layer).numpy()
    j = [jnp.asarray(a) for a in (q, kn, vn, ck, cv)]
    o1, ck1, cv1 = carry_decode_attention(*j, jnp.asarray(idx), jnp.asarray(bias), layer)
    o2, ck2, cv2 = fused_decode_attention(*j, jnp.asarray(idx), jnp.asarray(bias), jnp.asarray(layer),
                                          interpret=True)
    for o in (o1, o2):
        assert np.asarray(o).dtype == np.float32
        np.testing.assert_allclose(out, np.asarray(o), rtol=0, atol=1e-5)
    for c_t, c1, c2 in ((t[3], ck1, ck2), (t[4], cv1, cv2)):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c1))
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c2))
    if case == "no_open_slot_and_write_past_s":  # the row without an open slot: the mean of V
        v_mean = t[4][layer, 3].numpy().mean(axis=0)
        np.testing.assert_allclose(out[3].reshape(KV, QH // KV, HD),
                                   np.broadcast_to(v_mean[:, None], (KV, QH // KV, HD)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("s", [64, 100, 128, 256, 384, 4096, 8200])
@pytest.mark.parametrize("b", [1, 4, 32])
def test_plan_f32_covers_every_slot_once(b, s):
    """The float32 route's launch plan: at most MAX_CLUSTER_F32 blocks a
    cluster (the source takes up to 16), runs of a multiple of GROUP_F32
    slots that cover [0, S) once each with no empty block, chunks of at most
    CHUNK_F32 slots that cover a run, and a block's shared memory within the
    card's budget for any group size."""
    n, per = tda.plan_f32(b, s, KV)
    assert 1 <= n <= tda.MAX_CLUSTER_F32 <= 16
    assert per % tda.GROUP_F32 == 0 and per >= tda.GROUP_F32
    runs = [range(r * per, min((r + 1) * per, s)) for r in range(n)]
    assert all(len(run) > 0 for run in runs)
    assert sorted(i for run in runs for i in run) == list(range(s))
    chunk = tda.chunk_f32(per)
    assert chunk % tda.GROUP_F32 == 0 and tda.GROUP_F32 <= chunk <= tda.CHUNK_F32
    assert -(-per // chunk) == -(-per // tda.CHUNK_F32)  # as few chunks as CHUNK_F32 allows
    for g in range(1, 9):
        assert tda.smem_bytes_f32(n, per, g) <= tda.SMEM_LIMIT


def _c_params(fname: str) -> list:
    """The ctypes types of a C entry's parameters, read from its declaration
    in csrc/decode_attention.cu."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    decl = re.search(r'extern "C" int ' + fname + r"\((.*?)\)\s*\{", src, re.S)
    assert decl, fname
    kinds = {"void*": ctypes.c_void_p, "longlong": ctypes.c_longlong, "int": ctypes.c_int}
    return [kinds[re.sub(r"\bconst\b|\s", "", param.strip().rsplit(None, 1)[0])] for param in decl.group(1).split(",")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_args_match_the_entry(dtype):
    """The wrapper's arguments (launch_args and the stream) against the C
    entry of the dtype's route: its declaration in the source, and the
    argument types ops/_build.py gives ctypes; the launch plan last."""
    b, s = 3, 200
    q = torch.zeros((b, QH, HD), dtype=dtype)
    kn, vn = torch.zeros((b, KV, HD), dtype=dtype), torch.zeros((b, KV, HD), dtype=dtype)
    ck, cv = torch.zeros((L, b, s, KV, HD), dtype=dtype), torch.zeros((L, b, s, KV, HD), dtype=dtype)
    idx, bias = torch.zeros(b, dtype=torch.int32), torch.zeros((b, s))
    args = tda.launch_args(q, kn, vn, ck, cv, idx, bias, torch.empty_like(q), L - 1)
    source, fname, argtypes = _build._SIGNATURES[tda.ROUTES[dtype]]
    assert source == "decode_attention"
    assert _c_params(fname) == argtypes
    assert len(args) + 1 == len(argtypes) and argtypes[-1] is ctypes.c_void_p  # + the stream
    for a, kind in zip(args, argtypes):
        assert isinstance(a, int) and (kind is not ctypes.c_int or -2**31 <= a < 2**31)
    assert args[11:18] == (L, b, s, KV, QH // KV, HD, L - 1)
    assert args[-2:] == (tda.plan_f32 if dtype == torch.float32 else tda.plan)(b, s, KV)
