"""One sharded training step on n processes
(__graft_entry__.dryrun_multichip's counterpart for the port).

    python -m fangyan_tts_torch.parallel.dryrun 8      # 8 processes over gloo, on the cards
    torchrun --nproc_per_node 4 -m fangyan_tts_torch.parallel.dryrun   # card LOCAL_RANK a process, nccl
    python -m fangyan_tts_torch.parallel.dryrun 8 --device cpu   # 8 CPU processes over gloo

The processes run on the cards unless `--device cpu` asks for the CPU:
under torchrun each on card LOCAL_RANK over nccl; spawned, process r on
card r mod the cards over gloo (nccl refuses two processes on one card).
n (under torchrun, WORLD_SIZE) is factored as the JAX one does (tp = 2 when
n is even, then fsdp = 2 when the rest is even, dp the rest); each process
builds the same small LM (bf16 compute) and DiT flow (float32) from a seed,
takes one step of each unsharded, then shards them on the dp x fsdp x tp
mesh and takes the same steps: one LM step with two microbatches
accumulated in the step, one flow step. Then the serving direction, as the
JAX one: a small TTS (heads of 64, the kernels' width; bf16 on a card,
float32 on the CPU) decodes SERVE_STEPS teacher-forced steps and streams
two token2wav hops (the second a window hop) on one process, then again
with the LM sharded and `shard_token2wav` over a dp x tp mesh (the decode
and flash kernels at their per-rank heads on a card). Exits non-zero when
a process fails, a value is not finite, a sharded loss is off the
unsharded one by more than LLM_REL_TOL (bf16 compute) or FLOW_REL_TOL
(float32), the sharded logits (the decode runs in the bf16 cache) off the
one-process ones by more than LLM_REL_TOL or the mel by more than its
dtype's tolerance (of max |.|), or the group takes longer than its
timeout.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np

LLM_REL_TOL = 5e-2  # bf16 GEMMs round by the rows a call holds
FLOW_REL_TOL = 1e-4
SERVE_STEPS, SERVE_WINDOW, SERVE_TOKENS = 12, 50, 80


def factor(n: int) -> dict:
    tp = 2 if n % 2 == 0 else 1
    rest = n // tp
    fsdp = 2 if rest % 2 == 0 else 1
    return {"dp": rest // fsdp, "fsdp": fsdp, "tp": tp}


def _configs():
    from ..config import DiTConfig, FlowConfig, LLMConfig, QwenConfig

    qwen = QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=32, vocab_size=512)
    llm = LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=64, extra_tokens=8, qwen=qwen)
    dit = DiTConfig(dim=128, depth=2, heads=4, dim_head=32, ff_mult=2, static_chunk_size=4)
    return llm, FlowConfig(input_size=80, vocab_size=64, dit=dit, n_timesteps=2)


def _serve_config():
    from ..config import CosyVoiceConfig, DiTConfig, FlowConfig, HiFTConfig, LLMConfig, QwenConfig

    qwen = QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, vocab_size=512)
    llm = LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=64, extra_tokens=8, qwen=qwen)
    dit = DiTConfig(dim=128, depth=2, heads=4, dim_head=64, ff_mult=2, static_chunk_size=50)
    return CosyVoiceConfig(llm=llm, flow=FlowConfig(vocab_size=64, n_timesteps=2, dit=dit),
                           hift=HiFTConfig(base_channels=32, f0_cond_channels=16, stream_noise_seconds=2))


def _serve(tts) -> dict:
    """SERVE_STEPS teacher-forced decode steps of two left-padded prompts
    (every logits row) and two token2wav hops."""
    import torch

    from ..data.lm_plan import build_prompt_plan, pad_plans_left
    from ..infer.stream import FlowStream
    from ..models import qwen2 as q

    rng = np.random.default_rng(1)
    c, dev = tts.cfg.llm, tts.device
    plans = [build_prompt_plan(c, rng.integers(0, 512, n).tolist(), rng.integers(0, 64, m).tolist())
             for n, m in ((9, 4), (5, 2))]
    p = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in pad_plans_left(plans, length=16).items()}
    tokens = torch.from_numpy(rng.integers(0, 64, (SERVE_STEPS, 2)).astype(np.int32)).to(dev)
    model = tts.llm
    with torch.no_grad():
        cache = q.init_cache(model.cfg.qwen, 2, 64, dtype=torch.bfloat16, device=dev)
        rows = [model.decode_logits(model.prefill_leftpad(p["src"], p["ids"], p["lengths"], cache))]
        start = (16 - p["lengths"]).to(torch.int32)
        for i in range(SERVE_STEPS):
            rows.append(model.decode_step(tokens[i], (p["lengths"] + i)[:, None].to(torch.int32), start, 16 + i + 1,
                                          cache))
    emb = rng.standard_normal(192).astype(np.float32)
    fs = FlowStream(tts, np.zeros(0, np.int32), np.zeros((0, 80), np.float32), emb, prompt_pad=0)
    stream = rng.integers(0, 64, SERVE_TOKENS).astype(np.int32)
    hops = [fs.step(stream).float().cpu().numpy() for _ in range(2)]
    return {"logits": torch.stack(rows).float().cpu().numpy(), "mel": np.stack(hops)}


def _steps(model, tx, mesh, make_step, batch, rng) -> float:
    """The loss of one step: unsharded (mesh None) or sharded on mesh."""
    from ..train import trainer

    state = trainer.init_state(model, tx)
    if mesh is not None:
        state = trainer.shard_state(state, mesh, tx)
    _, m = make_step(model, tx, mesh)(state, batch, rng)
    return float(m["loss"])


def _rank(rank: int, world: int, spec: dict, device: str = "cuda") -> dict:
    import functools

    import torch

    from ..data.dataset import stack_microbatches
    from ..data.lm_plan import build_plan, pad_plans_right
    from ..models.flow import CausalMaskedDiffWithDiT
    from ..models.llm import CosyVoice3LM
    from ..ops.device import exact_fp32
    from ..train import trainer
    from ..train.scheduler import build_optimizer
    from .mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and torch.distributed.is_initialized():  # spawned: gloo, card r mod the cards
        torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_mesh(**spec, device=device)
    if dev.type == "cuda":
        exact_fp32()
    llm_cfg, flow_cfg = _configs()
    rng = np.random.default_rng(0)
    b = max(2 * mesh.data_size, 2)
    plans = [build_plan(llm_cfg, rng.integers(0, 512, (5,)).tolist(), rng.integers(0, 64, (20,)).tolist())
             for _ in range(b)]
    batch = pad_plans_right(plans, 32)
    stacked = next(stack_microbatches(iter([batch, batch]), 2))
    lm = trainer.random_module(lambda: CosyVoice3LM(llm_cfg, dtype=torch.bfloat16), 0, dev)
    tx = build_optimizer(lr=1e-5, scheduler="constantlr", grad_clip=5.0)
    llm_step = functools.partial(trainer.make_llm_train_step, accum=2)
    out = {"loss_one": _steps(copy.deepcopy(lm), tx, None, llm_step, stacked, None)}
    out["loss"] = _steps(lm, tx, mesh, llm_step, stacked, None)

    lt = 8
    fbatch = {"token": rng.integers(0, 64, (b, lt)).astype(np.int32), "token_len": np.full((b,), lt, np.int32),
              "feat": rng.standard_normal((b, lt * 2, 80)).astype(np.float32),
              "feat_len": np.full((b,), lt * 2, np.int32),
              "embedding": rng.standard_normal((b, 192)).astype(np.float32)}
    flow = trainer.random_module(lambda: CausalMaskedDiffWithDiT(flow_cfg), 0, dev)
    ftx = build_optimizer(lr=1e-4, scheduler="constantlr", grad_clip=5.0)
    gen = lambda: torch.Generator(device=dev).manual_seed(3)  # the same draws on both runs
    out["flow_loss_one"] = _steps(copy.deepcopy(flow), ftx, None, trainer.make_flow_train_step, fbatch, gen())
    out["flow_loss"] = _steps(flow, ftx, mesh, trainer.make_flow_train_step, fbatch, gen())

    from ..infer.tts import CosyVoice3TTS
    from ..ops import device as kernel_device
    from .sharding import shard_module

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    tts = CosyVoice3TTS.random_init(_serve_config(), dtype=dtype, device=dev)
    tts.stream_window_tokens = SERVE_WINDOW
    one = _serve(tts)
    serve_mesh = make_mesh(dp=world // spec["tp"], tp=spec["tp"], device=device)  # no fsdp: inference
    shard_module(tts.llm, serve_mesh)
    tts.shard_token2wav(serve_mesh)
    kernel_device.launches.clear()
    got = _serve(tts)
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    out.update(logits_rel=rel(got["logits"], one["logits"]), mel_rel=rel(got["mel"], one["mel"]),
               mel_tol=LLM_REL_TOL if dtype == torch.bfloat16 else FLOW_REL_TOL,
               decode_launches=kernel_device.launches["decode_attention"],
               flash_launches=kernel_device.launches["chunk_flash_attention"])
    return out


def _check(out: dict) -> None:
    print(f"llm sharded step (accum-2 in-step): loss={out['loss']:.6f} (unsharded {out['loss_one']:.6f}); "
          f"flow sharded step: loss={out['flow_loss']:.6f} (unsharded {out['flow_loss_one']:.6f}); "
          f"TP decode ({SERVE_STEPS} teacher-forced steps, the bf16 cache) logits rel {out['logits_rel']:.3e} (limit "
          f"{LLM_REL_TOL}), TP token2wav 2 hops mel rel {out['mel_rel']:.3e} (limit {out['mel_tol']}); kernel "
          f"launches: decode "
          f"{out['decode_launches']}, flash {out['flash_launches']}", flush=True)
    if not all(np.isfinite(v) for v in out.values()):
        raise RuntimeError(f"dryrun: a value is not finite: {out}")
    rel = lambda a, b: abs(out[a] - out[b]) / abs(out[b])
    if rel("loss", "loss_one") > LLM_REL_TOL or rel("flow_loss", "flow_loss_one") > FLOW_REL_TOL:
        raise RuntimeError(f"dryrun: a sharded loss is off the unsharded one: {out}")
    if out["logits_rel"] > LLM_REL_TOL or out["mel_rel"] > out["mel_tol"]:
        raise RuntimeError(f"dryrun: the sharded decode or token2wav is off the one-process run: {out}")


def dryrun_multichip(n_devices: int, timeout: float = 600.0, device: str = "cuda") -> dict:
    """Run the steps on n_devices gloo processes, on the cards (process r on
    card r mod the cards) or, with device "cpu", on the CPU; returns rank
    0's losses. Raises on a failure or a loss that is off (see the module
    docstring)."""
    from .launch import spawn

    _need(device)
    spec = factor(n_devices)
    print(f"dryrun mesh: dp={spec['dp']} fsdp={spec['fsdp']} tp={spec['tp']} over {n_devices} processes "
          f"({device})", flush=True)
    out = spawn(_rank, n_devices, args=(spec, device), timeout=timeout)[0]
    _check(out)
    return out


def _need(device: str) -> None:
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device; pass --device cpu to run on the CPU")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="processes to spawn (ignored under torchrun)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default: under torchrun card LOCAL_RANK over nccl, spawned card r mod the cards "
                         "over gloo) or cpu (gloo)")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        dryrun_multichip(args.n, device=args.device)
        return 0
    _need(args.device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    spec = factor(world)
    out = _rank(rank, world, spec, args.device)
    if rank == 0:
        import torch

        where = torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu"
        print(f"dryrun mesh: dp={spec['dp']} fsdp={spec['fsdp']} tp={spec['tp']} over {world} processes "
              f"(torchrun, {torch.distributed.get_backend()}, {where})", flush=True)
        _check(out)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
