"""fangyan_tts_torch.ops.{quant,int4_matmul} against the JAX package:
quantization gives bit-equal ints and scales on float32 and bf16 weights,
2-D and stacked; the port's int8_dot and int4_matmul_plain agree with the
JAX int8_dot / int4_dot (float32 atol 1e-5, bf16 atol 2e-2 on outputs of
order one) and with the Pallas int4_matmul run in interpret mode (float32,
atol 1e-5: the CPU runs that kernel in float32 only); the port's state
walkers equal from_jax of the JAX tree walkers bit for bit."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fangyan_tts_torch.models.from_jax import flow_from_jax, llm_from_jax
from fangyan_tts_torch.ops import int4_matmul as ti4
from fangyan_tts_torch.ops import quant as tq
from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT
from fangyan_tts_tpu.models.llm import CosyVoice3LM
from fangyan_tts_tpu.ops import quant as jq
from fangyan_tts_tpu.ops.int4_matmul import int4_matmul as pallas_int4_matmul
from torch_port_util import both, np_params

JC, TC = both()


def _weights(shape, dtype: str, seed: int = 0):
    """The same weights on both sides: a JAX array and a torch tensor."""
    w = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05).astype(dtype)
    return w, torch.from_numpy(np.array(w.astype(jnp.float32))).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape", [(64, 96), (3, 128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["quantize_int8", "quantize_int4_packed"])
def test_quantize_bit_equal(fn, dtype, shape):
    jw, tw = _weights(shape, dtype)
    jqv, js = getattr(jq, fn)(jw)
    tqv, ts = getattr(tq, fn)(tw)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("fn", ["int8", "int4"])
def test_dot_matches_jax(fn, dtype, atol):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((128, 256)).astype(np.float32) / np.sqrt(128)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    if fn == "int8":
        q, s = jq.quantize_int8(jnp.asarray(w))
        want, got = jq.int8_dot(jx, q, s), tq.int8_dot(tx, torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)))
    else:
        q, s = jq.quantize_int4_packed(jnp.asarray(w))
        want = jq.int4_dot(jx, q, s)
        got = ti4.int4_matmul_plain(tx, torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)))
    assert got.dtype == tx.dtype and got.shape == (2, 5, 256)
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(want).mean() > 0.3  # outputs of order one
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("m", [1, 5, 33])
def test_int4_plain_matches_pallas_interpret(m, n):
    rng = np.random.default_rng(m * n)
    q, s = jq.quantize_int4_packed(jnp.asarray(rng.standard_normal((64, n)).astype(np.float32) / 8))
    x = rng.standard_normal((m, 64)).astype(np.float32)
    want = np.asarray(pallas_int4_matmul(jnp.asarray(x), q, s, interpret=True))
    got = ti4.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("int4_mlp", [False, True])
def test_quantize_qwen_state_equals_jax(int4_mlp):
    t = jnp.zeros((1, 8), jnp.int32)
    p = np_params(CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t)
    qcfg = replace(TC.llm, qwen=replace(TC.llm.qwen, quant_int8=True, quant_int4_mlp=int4_mlp))
    want = llm_from_jax(jq.quantize_qwen_params(p, int4_mlp=int4_mlp), qcfg)
    got = tq.quantize_qwen_state(llm_from_jax(p, TC.llm), int4_mlp=int4_mlp)
    _assert_state_equal(got, want)
    assert ("llm.layers.0.mlp.down_proj.kernel_q4" in got) == int4_mlp
    assert got["llm.layers.1.self_attn.qkv_proj.kernel_q"].shape == (64, 128)  # JAX (in, out) layout


@pytest.mark.parametrize("which", ["llm int8", "llm int8 + int4 mlp", "dit int8"])
def test_quantized_config_refuses_float_weights(which):
    """random_init makes float weights; a quantized config's QLinear must
    refuse them instead of running them through int8_dot / int4_matmul."""
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    if which == "dit int8":
        cfg = replace(TC, flow=replace(TC.flow, dit=replace(TC.flow.dit, quant_int8=True)))
    else:
        qwen = replace(TC.llm.qwen, quant_int8=True, quant_int4_mlp=which.endswith("mlp"))
        cfg = replace(TC, llm=replace(TC.llm, qwen=qwen))
    with pytest.raises(ValueError, match="must be torch.int8"):
        CosyVoice3TTS.random_init(cfg, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("m, k, n", [(1, 896, 9728), (16, 896, 9728), (2048, 896, 9728),
                                     (1, 4864, 896), (16, 4864, 896), (2048, 4864, 896), (5, 64, 128)])
def test_int4_plan_covers_k(m, k, n):
    """The wrapper's launch plan meets the kernel's own argument checks, in
    one launch: a block covers all of its tokens' tile, and a cluster of at
    most MAX_CLUSTER blocks splits K in ranges of `per` steps that cover
    every step exactly once; K is split only where the output tiles leave
    SMs idle."""
    for sms in (8, 132):
        tile_m, tile_n, cs, per = ti4.plan(m, k, n, sms)
        steps = -(-k // ti4.STEP_K[tile_m])
        assert n % tile_n == 0
        # the kernel's own block shapes
        assert (tile_m, tile_n) in ((16, 64), (128, 128)) or (tile_m, tile_n, cs) == (128, 256, 1)
        assert 1 <= cs <= ti4.MAX_CLUSTER and per >= 1
        ranges = [range(r * per, min((r + 1) * per, steps)) for r in range(cs)]
        assert all(len(r) > 0 for r in ranges)  # no block of the cluster idles
        assert [s for r in ranges for s in r] == list(range(steps))
        if (n // tile_n) * -(-m // tile_m) >= sms:
            assert cs == 1  # enough output tiles: no split


@pytest.mark.parametrize("m, tile_m", [(1, 16), (16, 16), (17, 128), (64, 128), (65, 128), (100, 128), (512, 128),
                                       (2048, 128)])
def test_int4_plan_routes(m, tile_m):
    """Tile boundaries: 16-token blocks of 64 channels up to M = 16, then
    128-token blocks (256 channels where they fill the card); at decode
    down_proj's 14 column tiles split K over seven or eight blocks a
    cluster, while gate_up_proj's 152 fill the card alone."""
    for k, n in ((896, 9728), (4864, 896)):
        got, tile_n, cs, per = ti4.plan(m, k, n, 132)
        assert got == tile_m
        assert tile_n == (64 if m <= 16 else 256 if n == 9728 and m >= 512 else 128)
        if m <= 16:
            assert (cs == 1) if n == 9728 else (cs >= 7)


F32_SHAPES = [(896, 9728), (4864, 896)]  # gate_up_proj, down_proj


def _f32_kernel_accepts(m, k, n, tile_m, tile_n, cs, per) -> bool:
    """csrc/int4_matmul.cu fangyan_int4_matmul_f32's own argument checks."""
    decode = tile_m in ti4.F32_DECODE_M
    steps = k // ti4.F32_STEP_K[tile_m]
    return ((decode or tile_m == ti4.F32_PREFILL_M) and not (decode and m > tile_m) and tile_n in (64, 128)
            and m >= 1 and k >= 64 and k % 64 == 0 and n >= tile_n and n % tile_n == 0
            and 1 <= cs <= ti4.MAX_CLUSTER and per >= 1 and (cs - 1) * per < steps <= cs * per
            and -(-m // ti4.F32_PREFILL_M) * cs <= 65535)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 100, 128])
@pytest.mark.parametrize("k, n", F32_SHAPES)
def test_int4_plan_f32_covers_k(m, k, n):
    """The float32 route's plan, at the shapes phase 3 of chip_smoke.py
    checks, on a card of 8 and of 132 SMs: it meets the kernel's argument
    checks in one launch; the cluster's K ranges cover every step exactly
    once, none empty, with at most MAX_CLUSTER blocks; K is split only where
    the output tiles leave SMs idle (the decode tile: fewer tiles than
    resident blocks; the prefill tile: a last round of tiles that does not
    fill every SM)."""
    for sms in (8, 132):
        tile_m, tile_n, cs, per = ti4.plan_f32(m, k, n, sms)
        assert _f32_kernel_accepts(m, k, n, tile_m, tile_n, cs, per)
        steps = k // ti4.F32_STEP_K[tile_m]
        ranges = [range(r * per, min((r + 1) * per, steps)) for r in range(cs)]
        assert all(len(r) > 0 for r in ranges)  # no block of the cluster idles
        assert [s for r in ranges for s in r] == list(range(steps))
        tiles = n // tile_n * -(-m // tile_m)
        if cs > 1 and tile_m in ti4.F32_DECODE_M:
            assert tiles < ti4.F32_BLOCKS_PER_SM * sms
        elif cs > 1:
            assert -(-tiles // sms) * sms > tiles


@pytest.mark.parametrize("m, tile_m", [(1, 4), (4, 4), (5, 8), (8, 8), (9, 16), (16, 16), (17, 128), (100, 128),
                                       (128, 128), (2048, 128)])
def test_int4_plan_f32_routes(m, tile_m):
    """M up to 16 takes the decode tile in the smallest bucket that holds
    it (every row a real token), above it the 128-token prefill tile; at the
    float32 batch's shapes on 132 SMs the decode tile covers 128 channels of
    gate_up_proj (76 tiles, K split over 3) and 64 of down_proj (14 tiles, K
    split over 8)."""
    for k, n in F32_SHAPES:
        got, tile_n, cs, per = ti4.plan_f32(m, k, n, 132)
        assert got == tile_m
        if m <= 16:
            assert (tile_n, cs) == ((128, 3) if n == 9728 else (64, 8))


def test_quantize_dit_state_equals_jax():
    t = jnp.zeros((1, 8), jnp.int32)
    p = np_params(CausalMaskedDiffWithDiT(JC.flow), 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                  jnp.asarray([16]), jnp.zeros((1, 192)), jax.random.PRNGKey(0))
    fcfg = replace(TC.flow, dit=replace(TC.flow.dit, quant_int8=True))
    want = flow_from_jax(jq.quantize_dit_params(p), fcfg)
    got = tq.quantize_dit_state(flow_from_jax(p, TC.flow))
    _assert_state_equal(got, want)
    assert got["estimator.blocks.0.ff_2.kernel_q"].dtype == torch.int8
    assert got["estimator.input_proj.weight"].dtype == torch.float32  # glue layers stay float
