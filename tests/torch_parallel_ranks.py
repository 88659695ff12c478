"""The per-process halves of tests/test_torch_parallel.py. Each function runs
in one process of a group that fangyan_tts_torch.parallel.launch.spawn
starts (gloo on the CPU), takes the test's numpy inputs, and returns numpy
results for the test to assert. This module imports torch, numpy and the
port only, so that the spawned processes never import JAX."""

from __future__ import annotations

import numpy as np
import torch

from fangyan_tts_torch.parallel import gather_module, make_mesh, shard_module


def _np(sd: dict) -> dict:
    return {k: v.detach().float().numpy() if v.is_floating_point() else v.numpy() for k, v in sd.items()}


def _module(ctor, sd: dict) -> torch.nn.Module:
    m = ctor()
    m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return m


def _slots(opt_state) -> list[list]:
    """The parameter-shaped slot lists of an optimizer state, outermost first."""
    import dataclasses

    out = []
    while opt_state is not None:
        for f in dataclasses.fields(opt_state):
            v = getattr(opt_state, f.name)
            if isinstance(v, list):
                out.append(v)
        opt_state = getattr(opt_state, "inner", None)
    return out


def _shapes(model: torch.nn.Module, state) -> dict:
    names = [n for n, _ in model.named_parameters()]
    return {"params": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "buffers": {n: tuple(b.shape) for n, b in model.named_buffers()},
            "slots": [{n: tuple(t.shape) for n, t in zip(names, slot)} for slot in _slots(state.opt_state)]}


def _llm_step(job: dict, mesh, accum: int, batch_key: str, cfg_key: str = "llm_cfg", sd_key: str = "llm_sd"):
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import trainer
    from fangyan_tts_torch.train.scheduler import build_optimizer

    m = _module(lambda: CosyVoice3LM(job[cfg_key], dtype=torch.float32), job[sd_key]).train()
    tx = build_optimizer(lr=1e-3, scheduler="constantlr")
    state = trainer.shard_state(trainer.init_state(m, tx), mesh, tx)
    shapes = _shapes(m, state)
    state, metrics = trainer.make_llm_train_step(m, tx, mesh, accum=accum)(state, job[batch_key])
    return m, state, {k: float(v) for k, v in metrics.items()}, shapes


def train_rank(rank: int, world: int, job: dict) -> dict:
    """8 processes: dp2 x fsdp2 x tp2 LLM steps (accum 1 and 2) and flow
    steps (the JAX draws), local shapes, a checkpoint written under the
    mesh and read back, two equal-shaped layers, an fsdp=8 LLM step."""
    from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT
    from fangyan_tts_torch.models.from_jax import convert
    from fangyan_tts_torch.parallel.sharding import placement_tree
    from fangyan_tts_torch.train import trainer
    from fangyan_tts_torch.train.checkpoint import load_params, save_module
    from fangyan_tts_torch.train.scheduler import build_optimizer

    mesh = make_mesh(dp=2, fsdp=2, tp=2, device="cpu")
    out: dict = {"coord": mesh.coord}
    for accum in (1, 2):
        m, state, metrics, shapes = _llm_step(job, mesh, accum, f"llm_batch{accum}")
        out[f"llm{accum}"] = metrics
        whole = _np(gather_module(m))  # a collective: every process gathers, process 0 reports
        out[f"llm{accum}_params"] = whole if rank == 0 else None
        if accum == 1:
            out["llm_shapes"] = shapes
            out["llm_placements"] = placement_tree(m, mesh)
            # a checkpoint under the mesh: gathered, written by process 0, read back whole into an unsharded
            # module and sliced by the rules (as the CLIs load one)
            save_module(job["ckpt"], m, meta={"epoch": 0, "step": 1})
            torch.distributed.barrier()
            with torch.device("meta"):
                skeleton = type(m)(job["llm_cfg"])
            whole = {k: v.numpy() for k, v in convert(load_params(job["ckpt"]), skeleton).items()}
            fresh = shard_module(_module(lambda: type(m)(job["llm_cfg"], dtype=torch.float32), whole), mesh)
            out["ckpt_local_equal"] = all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                                             m.state_dict().values()))
    for accum in (1, 2):
        flow = _module(lambda: CausalMaskedDiffWithDiT(job["flow_cfg"]), job["flow_sd"]).train()
        tx = build_optimizer(lr=1e-3, scheduler="constantlr")
        state = trainer.shard_state(trainer.init_state(flow, tx), mesh, tx)
        if accum == 1:
            out["flow_shapes"] = _shapes(flow, state)
            out["flow_placements"] = placement_tree(flow, mesh)
        step = trainer.make_flow_train_step(flow, tx, mesh, accum=accum)
        draws = [{k: torch.from_numpy(v) for k, v in d.items()} for d in job[f"flow_draws{accum}"]]
        state, metrics = step(state, job[f"flow_batch{accum}"], draws[0] if accum == 1 else draws)
        out[f"flow{accum}"] = {k: float(v) for k, v in metrics.items()}
        whole = _np(gather_module(flow))
        out[f"flow{accum}_params"] = whole if rank == 0 else None

    # two layers of one shape whose rules differ keep their own placements, in the slots too
    pair = torch.nn.Module()
    pair.self_attn = torch.nn.Module()
    pair.self_attn.qkv_proj = torch.nn.Linear(64, 64)
    pair.self_attn.o_proj = torch.nn.Linear(64, 64, bias=False)
    tx = build_optimizer(lr=1e-3, scheduler="constantlr", accum_grad=2)
    state = trainer.shard_state(trainer.init_state(pair, tx), mesh, tx)
    out["pair_placements"] = placement_tree(pair, mesh)
    out["pair_shapes"] = _shapes(pair, state)

    # fsdp over every process: the large embedding's rows are gathered for the forward
    fsdp = make_mesh(fsdp=8, device="cpu")
    m, _, metrics, shapes = _llm_step(job, fsdp, 1, "big_batch", "big_cfg", "big_sd")
    out["big"] = metrics
    out["big_shapes"] = shapes
    whole = _np(gather_module(m))
    out["big_params"] = whole if rank == 0 else None
    return out


def _tp_decode(job: dict, mesh, sd_key: str, cfg) -> dict:
    from fangyan_tts_torch.models import qwen2 as q
    from fangyan_tts_torch.models.llm import CosyVoice3LM, generate_speech_tokens

    m = _module(lambda: CosyVoice3LM(cfg, dtype=torch.float32), job[sd_key]).eval()
    if mesh is not None:
        shard_module(m, mesh)
    d = {k: torch.from_numpy(v) for k, v in job["decode"].items()}
    out = generate_speech_tokens(m, d["src"], d["ids"], d["lens"], d["min_lens"], d["max_lens"],
                                 torch.Generator().manual_seed(7), job["max_new"], job["cache_len"])
    t = {k: torch.from_numpy(v) for k, v in job["plan"].items()}
    with torch.no_grad():  # teacher-forced logits over a right-padded plan
        x = m.embed_plan(t["src"], t["ids"])
        b, n, _ = x.shape
        pos = torch.arange(n, dtype=torch.int32).expand(b, n)
        logits = m.decode_logits(m.llm(x, pos, q.prefill_attn_bias(n, t["lengths"])))
    return {"tokens": out.tokens.numpy(), "num": out.num_tokens.numpy(), "logits": logits.numpy()}


def _hops(job: dict, mesh) -> list:
    from fangyan_tts_torch.infer.stream import FlowStream
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    tts = CosyVoice3TTS(job["tts_cfg"], *({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
                                          for sd in job["tts_sds"]), dtype=torch.float32, device="cpu")
    tts.stream_window_tokens = job["window"]
    if mesh is not None:
        tts.shard_token2wav(mesh)
    fs = FlowStream(tts, np.zeros(0, np.int32), np.zeros((0, 80), np.float32), job["emb"], prompt_pad=0)
    return [fs.step(job["tokens"]).numpy() for _ in range(2)]


def tp_rank(rank: int, world: int, job: dict) -> dict:
    """2 processes: TP=2 decode (float32, int8, int8 with the int4 MLP) and
    teacher-forced logits, two shard_token2wav hops, the refusals of
    make_mesh and shard_module."""
    from dataclasses import replace

    from fangyan_tts_torch.models.llm import CosyVoice3LM

    mesh = make_mesh(tp=2, device="cpu")
    out = {"f32": _tp_decode(job, mesh, "llm_sd", job["llm_cfg"]),
           "int8": _tp_decode(job, mesh, "llm_int8_sd", job["llm_int8_cfg"]),
           "int4": _tp_decode(job, mesh, "llm_int4_sd", job["llm_int4_cfg"]),
           "hops": _hops(job, mesh)}
    try:
        make_mesh(tp=4, device="cpu")
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    odd = replace(job["llm_cfg"], qwen=replace(job["llm_cfg"].qwen, num_key_value_heads=1))
    try:
        shard_module(CosyVoice3LM(odd), mesh)
        out["heads"] = None
    except ValueError as e:
        out["heads"] = str(e)
    return out


def one_process(job: dict) -> dict:
    """tp_rank's runs with no mesh (the test's own process)."""
    return {"f32": _tp_decode(job, None, "llm_sd", job["llm_cfg"]),
            "int8": _tp_decode(job, None, "llm_int8_sd", job["llm_int8_cfg"]),
            "int4": _tp_decode(job, None, "llm_int4_sd", job["llm_int4_cfg"]), "hops": _hops(job, None)}


def dp_rank(rank: int, world: int, job: dict) -> dict:
    """2 processes, or none (world 0: the test's own process): a DPO step and
    a GAN discriminator then generator turn, data-parallel over dp=2."""
    from fangyan_tts_torch.models.discriminators import MultipleDiscriminator
    from fangyan_tts_torch.models.hift import CausalHiFT
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import trainer
    from fangyan_tts_torch.train.dpo import make_dpo_train_step
    from fangyan_tts_torch.train.gan import init_gan_state, make_hifigan_steps, shard_gan_state
    from fangyan_tts_torch.train.scheduler import build_optimizer, plain_adam

    mesh = make_mesh(dp=2, device="cpu") if world else None
    out = {}
    m = _module(lambda: CosyVoice3LM(job["llm_cfg"], dtype=torch.float32), job["llm_sd"]).train()
    ref = trainer.frozen_copy(m)
    tx = build_optimizer(lr=1e-3, scheduler="constantlr")
    state = trainer.init_state(m, tx)
    if mesh is not None:
        state = trainer.shard_state(state, mesh, tx)
    state, metrics = make_dpo_train_step(m, ref, tx, mesh, beta=0.1)(state, job["dpo_batch"])
    out["dpo"] = {k: float(v) for k, v in metrics.items()}
    out["dpo_params"] = _np(gather_module(m))

    gen = _module(lambda: CausalHiFT(job["hift_cfg"]), job["hift_sd"]).train()
    disc = _module(lambda: MultipleDiscriminator(**job["disc_kw"]), job["disc_sd"]).train()
    gtx, dtx = plain_adam(1e-3), plain_adam(1e-3)
    gstate = init_gan_state(gen, disc, gtx, dtx)
    if mesh is not None:
        gstate = shard_gan_state(gstate, mesh)
    gen_step, disc_step = make_hifigan_steps(gen, disc, gtx, dtx, mesh=mesh)
    gstate, dm = disc_step(gstate, job["gan_batch"])
    gstate, gm = gen_step(gstate, job["gan_batch"])
    out["gan"] = {**{f"d_{k}": float(v) for k, v in dm.items()}, **{f"g_{k}": float(v) for k, v in gm.items()}}
    out["gan_params"] = {**_np(gen.state_dict()), **{f"disc.{k}": v for k, v in _np(disc.state_dict()).items()}}
    return out


def cli_rank(rank: int, world: int, module: str, argv: list) -> None:
    """One process of a CLI started as torchrun would start it (RANK and
    WORLD_SIZE set, the process group joined): `module`.main(argv)."""
    import importlib

    importlib.import_module(module).main(argv)
