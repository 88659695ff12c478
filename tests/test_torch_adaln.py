"""The DiT's AdaLN chain (fangyan_tts_torch/ops/adaln.py) on the CPU:

- `adaln_plain` is bit-equal to the DiT's former inline expressions, in
  bfloat16 and float32, with and without the gated residual, on row views
  of one `mod.chunk(6)` as the blocks take them;
- a DiTBlock and a DiTBlockChunk, run one after the other with each
  block's closing residual left to the next norm, and a whole DiT forward,
  are bit-equal to the former chain, written out below as the yardstick;
- CPU calls count `dit.norms` in the tracer and launch nothing; the route
  picks the kernel only where autograd records nothing (the kernel's
  launch is stubbed: the CPU has no Triton), so the training route takes
  the plain chain, and torch.export the custom op `fangyan::adaln`, whose
  CPU kernel and fake agree; an exported DiT gives the eager output;
- the kernel route's refusals (grad, operands it cannot read);
- the benchmark's reader of the counters, `dit_fused_norm_pct.datagen`.
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from fangyan_tts_torch.config import DiTConfig
from fangyan_tts_torch.models import dit as tdit
from fangyan_tts_torch.models.qwen2 import qdense
from fangyan_tts_torch.ops import adaln as an
from fangyan_tts_torch.ops import device
from fangyan_tts_torch.utils import profiling

OP = torch.ops.fangyan.adaln.default
CFG = DiTConfig(dim=64, depth=2, heads=2, dim_head=32, static_chunk_size=4, conv_pos_groups=4)
B, L = 2, 12


def old_layer_norm(x, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def old_block(blk, x, mod, *attn_args):
    """The DiT block's former forward; (x, *the chunk attention's k_new, v_new)."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    norm = old_layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    out, *kv = blk.attn(norm, *attn_args) if isinstance(blk, tdit.DiTBlockChunk) else (blk.attn(norm, *attn_args),)
    x = x + gate_msa[:, None] * out
    ff_norm = old_layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    h = qdense(F.gelu(qdense(ff_norm, blk.ff_0), approximate="tanh"), blk.ff_2)
    return (x + gate_mlp[:, None] * h, *kv)


def old_dit(dit, x, mu, t, spks, cond, mel_len, chunk, mods):
    """DiT.forward as it was: each block closes its own residual, and the
    final norm reads the closed hidden state."""
    t_emb, h = tdit._embed(dit, x, mu, t, spks, cond)
    h = dit.conv_pos_embed(h) + h
    freqs = torch.from_numpy(tdit._rotary_freqs(x.shape[1], dit.cfg.dim_head))
    cos, sin = torch.cos(freqs).to(x.dtype), torch.sin(freqs).to(x.dtype)
    for i, blk in enumerate(dit.blocks):
        h = old_block(blk, h, mods[i], mel_len, chunk, cos, sin)[0]
    scale, shift = tdit.flax_dense(F.silu(t_emb), dit.norm_out_linear, x.dtype).chunk(2, dim=-1)
    h = old_layer_norm(h) * (1 + scale)[:, None] + shift[:, None]
    return tdit.flax_dense(h, dit.proj_out, x.dtype)


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return module


def _dit(dtype, seed=0):
    return _randomize(tdit.DiT(CFG), seed).to(dtype).eval()


def _inputs(dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g).to(dtype)
    return dict(x=rnd(B, L, 80), mu=rnd(B, L, 80), t=torch.rand(B, generator=g).to(dtype), spks=rnd(B, 80),
                cond=rnd(B, L, 80), mel_len=torch.tensor([L, L - 5], dtype=torch.int32))


def _mods(dit, t, dtype):
    with torch.no_grad():
        return tdit.precompute_mods(dit, t[None], dtype)[0]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_is_the_old_chain(dtype, residual):
    g = torch.Generator().manual_seed(3)
    mod = (torch.randn((B, 6 * CFG.dim), generator=g) * 0.5).to(dtype)
    shift, scale, gate = mod.chunk(6, dim=-1)[:3]
    x, y = (torch.randn((B, L, CFG.dim), generator=g).to(dtype) for _ in range(2))
    want_x = x + gate[:, None] * y if residual else x
    want = old_layer_norm(want_x) * (1 + scale[:, None]) + shift[:, None]
    got_x, got = an.adaln_plain(x, scale, shift, *((y, gate) if residual else ()))
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(got_x, want_x)
    assert an.adaln(x, scale, shift, *((y, gate) if residual else ()))[1].equal(want)


@pytest.mark.parametrize("kind", ["block", "chunk_block"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_blocks_are_the_old_chain(dtype, kind):
    """Both blocks in turn, the first one's closing residual added by the
    second one's first norm, then the second one's closed by hand."""
    dit = _dit(dtype)
    inp = _inputs(dtype)
    mods = _mods(dit, inp["t"], dtype)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((B, L, CFG.dim), generator=g).to(dtype)
    cos, sin = (torch.randn((L, CFG.dim_head), generator=g).to(dtype) for _ in range(2))
    if kind == "block":
        blocks = dit.blocks
        args = (inp["mel_len"], 4, cos, sin)
    else:
        blocks = tdit.DiTChunk.of(dit).blocks
        cache = [torch.randn((B, CFG.heads, 8, CFG.dim_head), generator=g).to(dtype) for _ in range(2)]
        bias_c = torch.where(torch.rand((B, L, 8), generator=g) < 0.3, -1e9, 0.0)
        bias_n = torch.zeros((B, L, L))
        cos, sin = cos.expand(B, L, -1), sin.expand(B, L, -1)
        args = (*cache, cos, sin, bias_c, bias_n)
    with torch.no_grad():
        want, kv_want = x, []
        for i, blk in enumerate(blocks):
            want, *kv = old_block(blk, want, mods[i], *args)
            kv_want += kv
        got, res, kv_got = x, None, []
        for i, blk in enumerate(blocks):
            got, res, *kv = blk(got, mods[i], *args, res=res)
            kv_got += kv
        got = got + res[1][:, None] * res[0]
    assert torch.equal(got, want)
    assert len(kv_got) == len(kv_want) and all(torch.equal(a, b) for a, b in zip(kv_got, kv_want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dit_forward_is_the_old_chain(dtype):
    dit = _dit(dtype)
    inp = _inputs(dtype)
    mods = _mods(dit, inp["t"], dtype)
    with torch.no_grad():
        got = dit(**inp, chunk=4, mods=mods)
        want = old_dit(dit, **inp, chunk=4, mods=mods)
    assert torch.equal(got, want)


def test_cpu_counts_norms_and_launches_nothing():
    dit = _dit(torch.float32)
    inp = _inputs(torch.float32)
    before = device.launches.copy()
    profiling.reset()
    with profiling.recording(), torch.no_grad():
        dit(**inp, chunk=0)
    counters = profiling.counters()
    profiling.reset()
    assert counters.get("dit.norms") == 2 * CFG.depth + 1 and "dit.fused_norms" not in counters
    assert device.launches == before


@pytest.fixture
def stub_kernel(monkeypatch):
    """CPU tensors routed as the card's would be, with the launch replaced by
    the kernel route's checks and the plain version; the stub's calls are
    counted."""
    calls = []

    def fused(*a, **k):
        an._check(*a[:5])  # what the launch would refuse
        calls.append(a[0].shape)
        return an.adaln_plain(*a, **k)

    monkeypatch.setattr(an, "KERNEL_DEVICES", ("cpu",))
    monkeypatch.setattr(an, "adaln_fused", fused)
    return calls


class _Wrapped(torch.nn.Module):
    def __init__(self, dit, mods):
        super().__init__()
        self.dit, self.mods = dit, mods

    def forward(self, x, mu, t, spks, cond, mel_len):
        return self.dit(x, mu, t, spks, cond, mel_len, 4, self.mods)


@pytest.mark.parametrize("route", ["inference", "stream_hop", "training", "export"])
def test_route(stub_kernel, route):
    """Inference (no grad), a DiT call or a KV-cached streaming hop, takes
    the kernel for every norm, on operands it can read; the training
    forward with grad never reaches it, and a torch.export trace holds the
    op fangyan::adaln for each norm instead (its CPU kernel the plain
    version: the loaded program gives the eager output). Counted norms and
    fused norms follow the route."""
    dit = _dit(torch.float32)
    inp = _inputs(torch.float32)
    n = 2 * CFG.depth + 1
    profiling.reset()
    with profiling.recording():
        if route == "inference":
            with torch.no_grad():
                out = dit(**inp, chunk=4)
            ok = torch.isfinite(out).all()
        elif route == "stream_hop":
            chunk_dit, cap, pad = tdit.DiTChunk.of(dit), 8, CFG.conv_pos_kernel - 1
            kv = (CFG.depth, B, CFG.heads, cap, CFG.dim_head)
            cache = {"k": torch.randn(kv), "v": torch.randn(kv), "tail1": torch.randn((B, pad, CFG.dim)),
                     "tail2": torch.randn((B, pad, CFG.dim))}
            with torch.no_grad():
                out, _ = chunk_dit(inp["x"], inp["mu"], inp["t"], inp["spks"], inp["cond"], cache,
                                   torch.tensor([cap, cap - 3]), torch.zeros((B, L, cap)), torch.zeros((B, L, L)),
                                   _mods(dit, inp["t"], torch.float32))
            ok = torch.isfinite(out).all()
        elif route == "training":
            dit.train()
            out = dit(**inp, chunk=4, dense=True)
            out.square().mean().backward()
            ok = all(p.grad is not None for p in dit.blocks[0].attn_norm_linear.parameters())
        else:
            mods = _mods(dit, inp["t"], torch.float32)
            with torch.no_grad():
                eager = dit(**inp, chunk=4, mods=mods)
            stub_kernel.clear()
            profiling.reset()
            args = tuple(inp[k] for k in ("x", "mu", "t", "spks", "cond", "mel_len"))
            with torch.no_grad():
                ep = torch.export.export(_Wrapped(dit, mods), args)
                traced = len(stub_kernel)
                nodes = [nd for nd in ep.graph.nodes if nd.target is OP]
                ok = traced == 0 and len(nodes) == n and torch.equal(ep.module()(*args), eager)
    counters = profiling.counters()
    profiling.reset()
    assert ok
    if route in ("inference", "stream_hop"):
        assert len(stub_kernel) == n and counters == {"dit.norms": n, "dit.fused_norms": n}
    elif route == "training":
        assert stub_kernel == [] and counters == {"dit.norms": n}


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_op_cpu_kernel_and_fake(dtype, residual):
    """fangyan::adaln's CPU kernel and fake agree (opcheck), on the
    position convolutions' (B, D, L)-strided x; its outputs are the plain
    version's, in x's layout, and it counts no launch."""
    ops = {k: v.to(dtype) for k, v in _operands().items()}
    x = ops["x"].transpose(1, 2).contiguous().transpose(1, 2)
    res = (ops["y"], ops["gate"]) if residual else (None, None)
    args = (x, ops["scale"], ops["shift"], *res, 1e-6)
    torch.library.opcheck(OP, args)
    before = device.launches.copy()
    got = OP(*args)
    want = an.adaln_plain(*args[:5])
    assert device.launches == before and len(got) == 1 + residual
    assert all(g.stride() == x.stride() and torch.equal(g, w) for g, w in zip(got, want[2 - len(got):]))


def _operands(**change):
    g = torch.Generator().manual_seed(7)
    mod = torch.randn((B, 6 * CFG.dim), generator=g)
    shift, scale, gate = mod.chunk(6, dim=-1)[:3]
    ops = dict(x=torch.randn((B, L, CFG.dim), generator=g), scale=scale, shift=shift,
               y=torch.randn((B, L, CFG.dim), generator=g), gate=gate)
    ops.update(change)
    return ops


@pytest.mark.parametrize("bad", ["y_without_gate", "y_shape", "x_float16", "y_dtype", "y_device", "mod_strides",
                                 "mod_shape"])
def test_kernel_route_refuses_what_it_cannot_read(bad):
    ops = _operands()
    change = {"y_without_gate": dict(gate=None), "y_shape": dict(y=ops["y"][:, 1:]),
              "x_float16": dict(x=ops["x"].half()), "y_dtype": dict(y=ops["y"].double()),
              "y_device": dict(y=ops["y"].to("meta")), "mod_strides": dict(gate=ops["gate"].t().contiguous().t()),
              "mod_shape": dict(scale=ops["scale"][:1])}[bad]
    ops.update(change)
    with pytest.raises(ValueError):
        an._check(ops["x"], ops["scale"], ops["shift"], ops["y"], ops["gate"])


def test_kernel_route_refuses_grad():
    ops = _operands(x=torch.randn((B, L, CFG.dim), requires_grad=True))
    with pytest.raises(RuntimeError, match="no backward"):
        an.adaln_fused(**ops)


@pytest.mark.parametrize("counters,want", [({"dit.norms": 90, "dit.fused_norms": 90}, 100.0),
                                           ({"dit.norms": 90, "dit.fused_norms": 45}, 50.0),
                                           ({"dit.norms": 90}, 0.0), ({"llm.decode_steps": 3}, None)])
def test_fused_norm_share_reader(counters, want):
    from benchmark.harness import Cell

    rec = {"name": "flow", "t0_ns": 100_100_000_000, "t1_ns": 100_200_000_000, "parent": None, "thread": 1,
           "request": 0, "attrs": {}}
    ctx = {"trace": SimpleNamespace(_host_perf=100.0, window_s=1.0, offset_ns=None),
           "program_records": ([rec], counters), "spans": [], "window_s": 1.0}
    for cell in ("cv3.datagen_b16", "cv3moon.datagen_b16"):
        assert Cell(cell).reader("dit_fused_norm_pct.datagen")(dict(ctx)) == want
