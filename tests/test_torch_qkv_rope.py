"""The Qwen2 attention's qkv epilogue (fangyan_tts_torch/ops/qkv_rope.py) on
the CPU:

- `qkv_rope_plain` is bit-equal to the attention's former expressions (the
  bias added in the product's dtype, the split, NeoX rotation of q and k),
  in bfloat16 and float32, with the bias and without it (a tensor-parallel
  layer adds its own), at a decode step's one row and a prefill's rows;
- the route: autograd and a compiler's trace take the plain version, CPU
  tensors take it with no launch, and with the launch stubbed (the CPU has
  no Triton) an inference call reaches the kernel route, with or without
  the bias; `llm.qkv` and `llm.fused_qkv` follow the route;
- the kernel route's refusals (grad, operands it cannot read).
"""

import pytest
import torch

from fangyan_tts_torch.ops import device
from fangyan_tts_torch.ops import qkv_rope as qr
from fangyan_tts_torch.utils import profiling

QH, KV, HD = 14, 2, 64
W = (QH + 2 * KV) * HD
B, T = 3, 7


def old_rope(x, cos, sin):
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


def old_epilogue(qkv, bias, cos, sin):
    """The attention's former lines: qdense's bias in the result's dtype,
    then the split and the rotation."""
    b, t, _ = qkv.shape
    if bias is not None:
        qkv = qkv + bias.to(qkv.dtype)
    q, k, v = torch.split(qkv, [QH * HD, KV * HD, KV * HD], dim=-1)
    return old_rope(q.reshape(b, t, QH, HD), cos, sin), old_rope(k.reshape(b, t, KV, HD), cos, sin), \
        v.reshape(b, t, KV, HD)


def _operands(dtype=torch.float32, t=T, **change):
    from fangyan_tts_torch.models.qwen2 import rope_cos_sin

    g = torch.Generator().manual_seed(5)
    positions = torch.randint(0, 300, (B, t), generator=g, dtype=torch.int32)
    cos, sin = rope_cos_sin(positions, HD, 1e6, dtype=dtype)
    ops = dict(qkv=torch.randn((B, t, W), generator=g).to(dtype), bias=torch.randn(W, generator=g), cos=cos,
               sin=sin)
    ops.update(change)
    return ops


@pytest.mark.parametrize("t", [1, T])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_is_the_old_epilogue(dtype, with_bias, t):
    ops = _operands(dtype, t)
    bias = ops["bias"] if with_bias else None
    want = old_epilogue(ops["qkv"], bias, ops["cos"], ops["sin"])
    got = qr.qkv_rope_plain(ops["qkv"], bias, ops["cos"], ops["sin"], QH, KV)
    routed = qr.qkv_rope(ops["qkv"], bias, ops["cos"], ops["sin"], QH, KV)
    for g, r, w in zip(got, routed, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, w) and torch.equal(r, w)


def test_cpu_counts_and_launches_nothing():
    ops = _operands()
    before = device.launches.copy()
    profiling.reset()
    with profiling.recording():
        qr.qkv_rope(ops["qkv"], ops["bias"], ops["cos"], ops["sin"], QH, KV)
    counters = profiling.counters()
    profiling.reset()
    assert counters == {"llm.qkv": 1} and device.launches == before


@pytest.fixture
def stub_kernel(monkeypatch):
    """CPU tensors routed as the card's would be, with the launch replaced by
    the kernel route's checks and the plain version."""
    calls = []

    def fused(qkv, bias, cos, sin, heads, kv_heads):
        qr._check(qkv, bias, cos, sin, heads, kv_heads)
        calls.append(bias is not None)
        return qr.qkv_rope_plain(qkv, bias, cos, sin, heads, kv_heads)

    monkeypatch.setattr(device, "KERNEL_DEVICES", ("cpu",))
    monkeypatch.setattr(qr, "qkv_rope_fused", fused)
    return calls


@pytest.mark.parametrize("route", ["bias", "tensor_parallel", "grad", "compiling"])
def test_route(stub_kernel, monkeypatch, route):
    """An inference call takes the kernel, with the layer's bias or, as a
    tensor-parallel layer's product already holds its bias, without one;
    a call autograd records, or one under a compiler's trace, takes the
    plain version."""
    ops = _operands()
    bias = None if route == "tensor_parallel" else ops["bias"]
    if route == "grad":
        bias = bias.clone().requires_grad_()
    if route == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    profiling.reset()
    with profiling.recording():
        got = qr.qkv_rope(ops["qkv"], bias, ops["cos"], ops["sin"], QH, KV)
    counters = profiling.counters()
    profiling.reset()
    want = old_epilogue(ops["qkv"], bias, ops["cos"], ops["sin"])
    assert all(torch.equal(g.detach(), w.detach()) for g, w in zip(got, want))
    if route in ("bias", "tensor_parallel"):
        assert stub_kernel == [route == "bias"] and counters == {"llm.qkv": 1, "llm.fused_qkv": 1}
    else:
        assert stub_kernel == [] and counters == {"llm.qkv": 1}
    if route == "grad":
        got[0].sum().backward()
        assert bias.grad is not None


@pytest.mark.parametrize("bad", ["qkv_float16", "qkv_2d", "width", "head_dim_not_power_of_two", "cos_shape",
                                 "cos_strided", "bias_shape", "bias_strided", "bias_device", "qkv_columns_strided"])
def test_kernel_route_refuses_what_it_cannot_read(bad):
    ops = _operands()
    g = torch.Generator().manual_seed(9)
    change = {
        "qkv_float16": dict(qkv=ops["qkv"].half()),
        "qkv_2d": dict(qkv=ops["qkv"][0]),
        "width": dict(qkv=ops["qkv"][..., :-HD]),
        "head_dim_not_power_of_two": dict(qkv=torch.randn((B, T, (QH + 2 * KV) * 48), generator=g),
                                          cos=ops["cos"][..., :48].contiguous(),
                                          sin=ops["sin"][..., :48].contiguous()),
        "cos_shape": dict(cos=ops["cos"][:1]),
        "cos_strided": dict(cos=ops["cos"].transpose(0, 1).contiguous().transpose(0, 1)),
        "bias_shape": dict(bias=ops["bias"][1:]),
        "bias_strided": dict(bias=torch.randn(2 * W, generator=g)[::2]),
        "bias_device": dict(bias=ops["bias"].to("meta")),
        "qkv_columns_strided": dict(qkv=ops["qkv"].transpose(1, 2).contiguous().transpose(1, 2)),
    }[bad]
    ops.update(change)
    with pytest.raises(ValueError):
        qr._check(ops["qkv"], ops["bias"], ops["cos"], ops["sin"], QH, KV)


def test_kernel_route_refuses_grad():
    ops = _operands(qkv=torch.randn((B, T, W), requires_grad=True))
    with pytest.raises(RuntimeError, match="no backward"):
        qr.qkv_rope_fused(ops["qkv"], ops["bias"], ops["cos"], ops["sin"], QH, KV)
