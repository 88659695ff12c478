"""The port's model export (fangyan_tts_torch/cli/export.py) and the flash
kernel's custom op, on the CPU:

- `fangyan::chunk_flash_attention`: torch.library.opcheck on CPU tensors in
  bfloat16 and float32 (B 2, H 2, L 40 and 77, D 64, chunk 0 and 10); its
  CPU output equals chunk_flash_attention_plain bit for bit, in the CUDA
  kernel's (B, L, H, D) layout, and neither it nor an eager CPU call of
  the wrapper counts a launch; it is one node of an exported DiT's graph
  for each DiT block of each Euler step.
- The JAX package's `cli.export.main` and the port's, both with --check, on
  the tiny model directory of tests/test_torch_api.py (--n_tokens 32):
  the JAX `.stablehlo` programs (jax.export.deserialize, called with the
  parameter trees the JAX CLI saved) and the port's `.pt2` programs
  (torch.export.load) on the same numpy inputs give mel_len equal, mu,
  spks and conds within 1e-4, and the mel and the wav within 1e-3, in
  float32 (both CLIs' CosyVoice3 patched to fp16=False inside the test);
  tests/test_torch_export_bf16.py runs the same checks in bf16, as the
  CLIs run by default. The three msgpack files hold the same tree and
  equal leaves.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport

import fangyan_tts_torch.api as tapi
import fangyan_tts_tpu.api as japi
from fangyan_tts_torch.cli import export as tex
from fangyan_tts_torch.ops import device as tdevice
from fangyan_tts_torch.ops import flash_attention as tfa
from fangyan_tts_torch.train.checkpoint import load_params as torch_load_params
from fangyan_tts_tpu.cli import export as jex
from fangyan_tts_tpu.train.checkpoint import load_params as jax_load_params
from test_torch_api import JC, model_dir  # noqa: F401 (a fixture)

NT = 32  # --n_tokens: programs over 2 * NT = 64 mel frames
F32_ATOL = {"prep": 1e-4, "mel": 1e-3, "wav": 1e-3}
BF16_REL = 5e-2
OP = torch.ops.fangyan.chunk_flash_attention.default


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [40, 77])
@pytest.mark.parametrize("chunk", [0, 10])
def test_op_cpu_kernel(dtype, l, chunk):
    g = torch.Generator().manual_seed(l + chunk)
    q, k, v = (torch.randn((2, 2, l, 64), generator=g).to(dtype) for _ in range(3))
    mel_len = torch.tensor([l, l - 13], dtype=torch.int32)
    torch.library.opcheck(OP, (q, k, v, mel_len, chunk))
    before = tdevice.launches.copy()
    got = OP(q, k, v, mel_len, chunk)
    eager = tfa.chunk_flash_attention(q, k, v, mel_len, chunk)
    assert tdevice.launches == before
    assert got.dtype == dtype and got.shape == (2, 2, l, 64)
    assert got.transpose(1, 2).is_contiguous()  # a (B, H, L, D) view of (B, L, H, D) memory, as on the card
    want = tfa.chunk_flash_attention_plain(q, k, v, mel_len, chunk)
    assert torch.equal(got, want) and torch.equal(eager, want)


def _count_op(ep) -> int:
    return sum(1 for n in ep.graph.nodes if n.op == "call_function" and n.target == OP)


def test_op_is_a_node_of_an_exported_dit():
    from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT

    g = torch.Generator().manual_seed(0)
    flow = CausalMaskedDiffWithDiT(JC.flow).eval()
    with torch.no_grad():
        for t in flow.parameters():
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    solve = tex.FlowSolve(flow)
    l = 24
    args = (*(torch.randn((1, n, 80), generator=g) for n in (l, l)), torch.randn((1, 80), generator=g),
            torch.randn((1, l, 80), generator=g), torch.tensor([l - 4], dtype=torch.int32))
    with torch.no_grad():
        ep = torch.export.export(solve, args)
        assert _count_op(ep) == JC.flow.n_timesteps * JC.flow.dit.depth
        assert set(ep.state_dict) == {"estimator." + k for k in flow.estimator.state_dict()}
        want = solve(*args)
        assert torch.isfinite(want).all()
        torch.testing.assert_close(ep.module()(*args), want, rtol=0, atol=0)
    prep = tex.FlowPrepare(flow)
    assert not any(k.startswith("estimator") for k in prep.state_dict())


def _run_clis(model_dir, out, fp16: bool):
    """Both CLIs with --check into out/jax and out/torch, CosyVoice3 loaded
    with `fp16`."""
    mp = pytest.MonkeyPatch()
    mp.setattr(japi, "CosyVoice3", functools.partial(japi.CosyVoice3, fp16=fp16))
    mp.setattr(tapi, "CosyVoice3", functools.partial(tapi.CosyVoice3, fp16=fp16))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jex.main(["--model_dir", str(model_dir), "--output_dir", str(out / "jax"), "--n_tokens", str(NT),
                      "--check"])
            tex.main(["--model_dir", str(model_dir), "--output_dir", str(out / "torch"), "--n_tokens", str(NT),
                      "--check", "--device", "cpu"])
    finally:
        mp.undo()
    return out / "jax", out / "torch"


def export_pass(model_dir, out, fp16: bool) -> dict:
    """Both CLIs' outputs (their directories) and the port's programs loaded
    once."""
    jd, td = _run_clis(model_dir, out, fp16)
    progs = {n: torch.export.load(td / f"{n}.pt2") for n in ("flow_prepare", "flow_solve", "vocoder")}
    return dict(fp16=fp16, jax=jd, torch=td, progs=progs)


@pytest.fixture(scope="module")
def exported(model_dir, tmp_path_factory):  # noqa: F811
    return export_pass(model_dir, tmp_path_factory.mktemp("export"), fp16=False)


def _inputs(fp16: bool) -> dict:
    rng = np.random.default_rng(14)
    f = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    i32 = lambda *v: np.asarray(v, np.int32)  # noqa: E731
    return dict(
        prep=(rng.integers(0, JC.flow.vocab_size, (1, NT)).astype(np.int32), i32(NT - 3), f(1, 2 * NT, 80),
              i32(20), f(1, 192)),
        solve=(f(1, 2 * NT, 80), f(1, 2 * NT, 80, s=0.5), f(1, 80, s=0.5), f(1, 2 * NT, 80, s=0.5), i32(2 * NT - 10)),
        voc=(f(1, 2 * NT, 80, s=0.5) - 4.0,),
        dtype=(jnp.bfloat16, torch.bfloat16) if fp16 else (jnp.float32, torch.float32))


def _call_jax(d, name: str, params, args, jdt):
    prog = jexport.deserialize((d / f"{name}.stablehlo").read_bytes())
    cast = lambda a: jnp.asarray(a) if a.dtype == np.int32 else jnp.asarray(a, jdt)  # noqa: E731
    out = prog.call(params, *(cast(a) for a in args))
    return [np.asarray(jnp.asarray(o, jnp.float32)) for o in jax.tree.leaves(out)]


def _call_torch(ep, args, tdt):
    cast = lambda a: torch.from_numpy(a) if a.dtype == np.int32 else torch.from_numpy(a).to(tdt)  # noqa: E731
    with torch.no_grad():
        out = ep.module()(*(cast(a) for a in args))
    return [o.float().numpy() for o in (out if isinstance(out, (tuple, list)) else (out,))]


def check_programs(ex: dict) -> None:
    """The port's programs against the JAX package's on the same inputs."""
    fp16, jd, progs = ex["fp16"], ex["jax"], ex["progs"]
    x = _inputs(fp16)
    jdt, tdt = x["dtype"]
    flow_p, hift_p = jax_load_params(jd / "flow.msgpack"), jax_load_params(jd / "hift.msgpack")
    pairs = {
        "prep": (_call_jax(jd, "flow_prepare", flow_p, x["prep"], jdt), _call_torch(progs["flow_prepare"], x["prep"], tdt)),
        "mel": (_call_jax(jd, "flow_solve", flow_p["estimator"], x["solve"], jdt),
                _call_torch(progs["flow_solve"], x["solve"], tdt)),
        "wav": (_call_jax(jd, "vocoder", hift_p, x["voc"], jdt), _call_torch(progs["vocoder"], x["voc"], tdt)),
    }
    j_prep, t_prep = pairs["prep"]
    assert len(j_prep) == len(t_prep) == 4
    np.testing.assert_array_equal(t_prep[3], j_prep[3])  # mel_len
    assert int(t_prep[3][0]) == (NT - 3) * JC.flow.token_mel_ratio
    for key, (j, t) in pairs.items():
        for jo, to in zip(j[:3], t[:3]):
            assert jo.shape == to.shape and np.isfinite(to).all(), key
            if fp16:
                scale = np.abs(jo).max()
                assert np.abs(to - jo).max() <= BF16_REL * scale, (key, np.abs(to - jo).max(), scale)
            else:
                np.testing.assert_allclose(to, jo, rtol=0, atol=F32_ATOL[key], err_msg=key)
    assert pairs["wav"][1][0].shape == (1, 2 * NT * 480)
    assert np.abs(pairs["wav"][0][0]).max() > 1e-2


def check_flow_solve_holds_the_op(ex: dict) -> None:
    progs = ex["progs"]
    assert _count_op(progs["flow_solve"]) == JC.flow.n_timesteps * JC.flow.dit.depth
    assert {p.name for p in ex["torch"].glob("*.pt2")} == {"flow_prepare.pt2", "flow_solve.pt2", "vocoder.pt2"}
    assert not any(k.startswith("estimator") for k in progs["flow_prepare"].state_dict)
    assert not any(k.startswith("estimator") for k in progs["vocoder"].state_dict)


def _leaf(a) -> tuple[str, np.ndarray]:
    """(dtype name, float32 or int values) of a leaf of either reader."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch."), (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.dtype.name, a.astype(np.float32) if a.dtype.kind == "V" or a.dtype.name == "bfloat16" else a


def check_msgpack_trees(ex: dict) -> None:
    for name in ("llm", "flow", "hift"):
        jt = jax.tree_util.tree_flatten_with_path(jax_load_params(ex["jax"] / f"{name}.msgpack"))[0]
        tt = jax.tree_util.tree_flatten_with_path(torch_load_params(ex["torch"] / f"{name}.msgpack"),
                                                  is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
        assert [p for p, _ in jt] == [p for p, _ in tt], name
        for (path, a), (_, b) in zip(jt, tt):
            (da, va), (db, vb) = _leaf(a), _leaf(b)
            assert da == db and va.shape == vb.shape, (name, path, da, db, va.shape, vb.shape)
            np.testing.assert_array_equal(va, vb, err_msg=f"{name} {path}")


def test_programs_match_jax(exported):
    check_programs(exported)


def test_flow_solve_program_holds_the_op(exported):
    check_flow_solve_holds_the_op(exported)


def test_msgpack_trees_equal(exported):
    check_msgpack_trees(exported)
