"""The port's flax-msgpack reader and writer (train/checkpoint.py), its
inverse converter to_jax_tree (models/from_jax.py) and its copy of the
reference-checkpoint converters (models/convert.py), against the JAX
package:
- a tree that the JAX save_params writes is read by the port bit for bit
  (float32, bfloat16, int8, a numpy scalar, and a chunked leaf, the chunk
  size patched down for the test), and the port writes the same bytes;
- a tree that the port writes is read by the JAX load_params;
- to_jax_tree(convert(tree)) == tree for the LLM (plain and int8), flow,
  HiFT, CAM++ and S3 trees;
- the copied converters give the JAX converters' trees on the same
  state_dict, bit for bit."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import serialization

import test_convert as fake
from fangyan_tts_torch.models import convert as tconv
from fangyan_tts_torch.models import from_jax as fj
from fangyan_tts_torch.models.campplus import CAMPPlus as TorchCAMPPlus
from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT as TorchFlow
from fangyan_tts_torch.models.hift import CausalHiFT as TorchHiFT
from fangyan_tts_torch.models.llm import CosyVoice3LM as TorchLM
from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3 as TorchS3
from fangyan_tts_torch.train import checkpoint as tck
from fangyan_tts_tpu.models import convert as jconv
from fangyan_tts_tpu.models.flow import CausalMaskedDiffWithDiT
from fangyan_tts_tpu.models.hift import CausalHiFT
from fangyan_tts_tpu.models.llm import CosyVoice3LM
from fangyan_tts_tpu.ops import quant as jq
from fangyan_tts_tpu.train import checkpoint as jck
from torch_port_util import both, campplus_oracle, np_params, s3_oracle

JC, TC = both()
CAMP_TINY = dict(feat_dim=16, embedding_size=8, growth_rate=4, bn_size=4, init_channels=16, block_layers=(2, 2, 2))
CAMP_PORT = dict(feat_dim=16, embedding_size=8, growth=4, bn_size=4, init_channels=16, block_layers=(2, 2, 2))
S3_TINY = dict(n_mels=16, n_state=32, n_head=4, n_layer=2, kernel_size=7)
S3_PORT = dict(dim=32, heads=4, layers=2, n_mels=16, fsmn_kernel=7)


def _equal(a, b) -> bool:
    """Bit-equal leaves; a bfloat16 leaf may be a torch tensor on one side."""
    def bits(x):
        if isinstance(x, torch.Tensor):
            return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
        x = np.asarray(x)
        return x.view(np.int16) if x.dtype.name == "bfloat16" else x
    xa, xb = bits(a), bits(b)
    return xa.dtype == xb.dtype and xa.shape == xb.shape and np.array_equal(xa, xb)


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert sorted(got) == sorted(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert _equal(got[k], want[k]), f"{path}/{k}"


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "dense": {"kernel": rng.standard_normal((3, 5)).astype(np.float32), "bias": np.zeros((5,), np.float32)},
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)),
        "q": {"kernel_q": rng.integers(-128, 128, (8, 4)).astype(np.int8), "scale": np.ones((4,), np.float32)},
        "ints": np.arange(7, dtype=np.int32),
        "step": np.int64(1234),
        "lr": np.float32(3e-4),
        "big": rng.standard_normal((40,)).astype(np.float32),  # chunked when the chunk size is 64 bytes
        "big_bf16": np.asarray(jnp.asarray(rng.standard_normal((70,)), jnp.bfloat16)),
    }


@pytest.mark.parametrize("chunk", [None, 64])
def test_port_reads_what_jax_writes(tmp_path, monkeypatch, chunk):
    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(tck, "MAX_CHUNK_SIZE", chunk)
        assert serialization._chunk(np.zeros(40, np.float32))["__msgpack_chunked_array__"]
    tree = _mixed_tree()
    jck.save_params(tmp_path / "t.msgpack", tree)
    got = tck.load_params(tmp_path / "t.msgpack")
    _assert_trees_equal(got, tree)
    # save_params writes a numpy scalar as a 0-d array (ext type 1); flax's
    # serializer writes it as ext type 3, which the port reads as a scalar
    assert got["bf16"].dtype == torch.bfloat16 and got["step"].shape == () and got["step"].dtype == np.int64
    scalars = tck.msgpack_restore(serialization.msgpack_serialize({"s": np.float32(2.5), "i": np.int8(-3)}))
    assert type(scalars["s"]) is np.float32 and scalars["s"] == 2.5 and type(scalars["i"]) is np.int8
    # and the port writes the same bytes
    tck.save_params(tmp_path / "p.msgpack", got)
    assert (tmp_path / "p.msgpack").read_bytes() == (tmp_path / "t.msgpack").read_bytes()


@pytest.mark.parametrize("chunk", [None, 64])
def test_jax_reads_what_port_writes(tmp_path, monkeypatch, chunk):
    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(tck, "MAX_CHUNK_SIZE", chunk)
    tree = _mixed_tree()
    tree["torch_bf16"] = torch.randn(3, 4).to(torch.bfloat16)
    tree["torch_f32"] = torch.randn(2, 2)
    tck.save_params(tmp_path / "p.msgpack", tree, meta={"step": 3})
    got = jck.load_params(tmp_path / "p.msgpack")
    _assert_trees_equal(got, tree)
    assert jck.load_meta(tmp_path / "p.msgpack") == {"step": 3}


def test_reader_refuses_what_flax_does_not_write():
    with pytest.raises(ValueError, match="ext type 2"):  # a complex number
        tck.msgpack_restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="0xc1"):  # the one byte msgpack never uses
        tck.msgpack_restore(b"\x81\xa1a\xc1")
    with pytest.raises(ValueError, match="ends inside"):
        tck.msgpack_restore(serialization.msgpack_serialize({"a": np.zeros(4)})[:-3])
    with pytest.raises(TypeError, match="complex"):
        tck.msgpack_serialize({"c": 1 + 2j})


def _llm_tree():
    t = jnp.zeros((1, 8), jnp.int32)
    return np_params(CosyVoice3LM(JC.llm), 0, t, t, jnp.asarray([8]), t)


def _trees():
    t = jnp.zeros((1, 8), jnp.int32)
    llm = _llm_tree()
    return {
        "llm": (llm, lambda: TorchLM(TC.llm), lambda p: fj.llm_from_jax(p, TC.llm)),
        "flow": (np_params(CausalMaskedDiffWithDiT(JC.flow), 1, t, jnp.asarray([8]), jnp.zeros((1, 16, 80)),
                           jnp.asarray([16]), jnp.zeros((1, 192)), jax.random.PRNGKey(0)),
                 lambda: TorchFlow(TC.flow), lambda p: fj.flow_from_jax(p, TC.flow)),
        "hift": (np_params(CausalHiFT(JC.hift), 2, jnp.zeros((1, 16, 80))),
                 lambda: TorchHiFT(TC.hift), lambda p: fj.hift_from_jax(p, TC.hift)),
        "campplus": (jconv.campplus_params_from_torch(campplus_oracle(CAMP_TINY, 3).state_dict(),
                                                      CAMP_TINY["block_layers"]),
                     lambda: TorchCAMPPlus(**CAMP_PORT), lambda p: fj.campplus_from_jax(p, **CAMP_PORT)),
        "s3": (jconv.s3_params_from_torch(s3_oracle(S3_TINY, 11).state_dict())[0],
               lambda: TorchS3(**S3_PORT), lambda p: fj.s3_from_jax(p, **S3_PORT)),
    }


@pytest.mark.parametrize("name", ["llm", "flow", "hift", "campplus", "s3"])
def test_to_jax_tree_inverts_convert(name):
    tree, ctor, convert = _trees()[name]
    sd = convert(tree)
    back = fj.to_jax_tree(sd, ctor())
    _assert_trees_equal(back, jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("int4_mlp", [False, True])
def test_to_jax_tree_inverts_convert_quantized(int4_mlp):
    from dataclasses import replace

    qtree = jax.tree.map(np.asarray, jq.quantize_qwen_params(_llm_tree(), int4_mlp=int4_mlp))
    qcfg = replace(TC.llm, qwen=replace(TC.llm.qwen, quant_int8=True, quant_int4_mlp=int4_mlp))
    back = fj.to_jax_tree(fj.llm_from_jax(qtree, qcfg), TorchLM(qcfg))
    _assert_trees_equal(back, qtree)


def test_to_jax_tree_keeps_bf16_and_round_trips_through_msgpack(tmp_path):
    tree, ctor, convert = _trees()["s3"]
    sd = {k: v.to(torch.bfloat16) if v.dim() >= 2 else v for k, v in convert(tree).items()}
    back = fj.to_jax_tree(sd, ctor())
    assert back["blocks_0"]["q"]["kernel"].dtype == torch.bfloat16
    tck.save_params(tmp_path / "s3.msgpack", back)
    jtree = jck.load_params(tmp_path / "s3.msgpack")
    assert jtree["blocks_0"]["q"]["kernel"].dtype == jnp.bfloat16
    got = fj.s3_from_jax(tck.load_params(tmp_path / "s3.msgpack"), **S3_PORT)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_converters_equal_the_jax_ones():
    rng = np.random.default_rng(5)
    llm_sd = fake.fake_llm_sd(rng)
    for conv in (tconv, jconv):
        assert sorted(conv.filter_training_meta(llm_sd)) == sorted(set(llm_sd) - {"epoch", "step"})
    llm_sd = tconv.filter_training_meta(llm_sd)
    flow_sd, hift_sd = fake.fake_flow_sd(rng), fake.fake_hift_sd(rng)
    camp_sd = campplus_oracle(CAMP_TINY, 7).state_dict()
    s3_sd = s3_oracle(S3_TINY, 13).state_dict()
    pairs = [
        (tconv.llm_params_from_reference(llm_sd, num_layers=2), jconv.llm_params_from_reference(llm_sd, num_layers=2)),
        (tconv.flow_params_from_reference(flow_sd, depth=2), jconv.flow_params_from_reference(flow_sd, depth=2)),
        (tconv.dit_estimator_params(flow_sd, "decoder.estimator.", 2),
         jconv.dit_estimator_params(flow_sd, "decoder.estimator.", 2)),
        (tconv.hift_params_from_reference(hift_sd), jconv.hift_params_from_reference(hift_sd)),
        (tconv.campplus_params_from_torch(camp_sd, CAMP_TINY["block_layers"]),
         jconv.campplus_params_from_torch(camp_sd, CAMP_TINY["block_layers"])),
    ]
    for got, want in pairs:
        _assert_trees_equal(jax.tree.map(np.asarray, got), jax.tree.map(np.asarray, want))
    (p_t, h_t), (p_j, h_j) = tconv.s3_params_from_torch(s3_sd), jconv.s3_params_from_torch(s3_sd)
    assert h_t == h_j == {"dim": 32, "n_mels": 16, "layers": 2, "fsmn_kernel": 7}
    _assert_trees_equal(p_t, jax.tree.map(np.asarray, p_j))


def test_fuse_qwen_split_params_equal():
    fused = tconv.llm_params_from_reference(tconv.filter_training_meta(fake.fake_llm_sd(np.random.default_rng(6))),
                                            num_layers=2)
    attn, mlp = fused["llm"]["layers"]["self_attn"], fused["llm"]["layers"]["mlp"]
    legacy = dict(fused, llm=dict(fused["llm"], layers=dict(fused["llm"]["layers"])))
    k, b = attn["qkv_proj"]["kernel"], attn["qkv_proj"]["bias"]
    legacy["llm"]["layers"]["self_attn"] = {
        "o_proj": attn["o_proj"],
        "q_proj": {"kernel": k[..., :32], "bias": b[..., :32]},
        "k_proj": {"kernel": k[..., 32:48], "bias": b[..., 32:48]},
        "v_proj": {"kernel": k[..., 48:], "bias": b[..., 48:]},
    }
    g = mlp["gate_up_proj"]["kernel"]
    legacy["llm"]["layers"]["mlp"] = {"down_proj": mlp["down_proj"], "gate_proj": {"kernel": g[..., :64]},
                                      "up_proj": {"kernel": g[..., 64:]}}
    got, want = tconv.fuse_qwen_split_params(legacy), jconv.fuse_qwen_split_params(legacy)
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    _assert_trees_equal(got, fused)
    assert tconv.fuse_qwen_split_params(fused) == fused  # a fused tree is left as it is
    # torch bfloat16 leaves (train/checkpoint.py reads bf16 so) fuse too
    bf = {"q_proj": {"kernel": torch.ones(2, 3, dtype=torch.bfloat16)},
          "k_proj": {"kernel": torch.zeros(2, 1, dtype=torch.bfloat16)},
          "v_proj": {"kernel": torch.zeros(2, 1, dtype=torch.bfloat16)}}
    assert tconv.fuse_qwen_split_params(bf)["qkv_proj"]["kernel"].shape == (2, 5)
