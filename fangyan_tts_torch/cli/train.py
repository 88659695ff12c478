"""Training CLI (fangyan_tts_tpu/cli/train.py, the reference's bin/train.py),
with the JAX CLI's flags and defaults plus --device.

python -m fangyan_tts_torch.cli.train \
    --model llm --train_data data.list --cv_data cv.list \
    --model_dir exp/llm [--config conf.json] [--checkpoint init.msgpack] \
    [--tokenizer_path <hf-dir>] [--max_epoch 200] [--device cuda|cpu] ...

Trains CosyVoice3LM (float32 parameters, bf16 compute) or the DiT flow
(float32) on one device, CUDA unless --device cpu, from the parquet shards
that data prep writes (data/dataset.build_pipeline, stacked into --accum_grad
microbatches that each step accumulates before one optimizer apply). Weights
start from the JAX package's fast-init rules with --seed, or from
--checkpoint (resuming at the epoch and step of its json sidecar). The
model directory gets init.msgpack, step_N / epoch_N_whole checkpoints with
their sidecars and metrics.jsonl, in the JAX package's layout.

--model hifigan exits pointing at cli.train_gan, which trains the vocoder
against its discriminators (as the JAX CLI does). DPO is the library
train/dpo.py (make_dpo_train_step), as in the JAX package.

Departures from the JAX CLI: --mesh other than dp=1 raises (one device
here), --dpo raises (the JAX CLI parses it and never reads it: nothing in
either package wires DPO into this CLI), and the CV pipeline is built anew
for every checkpoint, so that a step_N checkpoint does not leave the
epoch's own checkpoint an empty CV set.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parse_mesh(spec: str) -> dict:
    out = {"dp": 1, "fsdp": 1, "tp": 1}
    for part in spec.split(","):
        if part:
            k, v = part.split("=")
            out[k] = int(v)
    return out


class _Reiterable:
    """An iterable whose every pass calls `make()` for a fresh iterator."""

    def __init__(self, make):
        self.make = make

    def __iter__(self):
        return iter(self.make())


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["llm", "flow", "hifigan"], required=True)
    p.add_argument("--train_data", required=True)
    p.add_argument("--cv_data", default=None)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--config", default=None, help="json config overriding CosyVoiceConfig defaults")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--qwen_pretrain_path", default="")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--mesh", default="dp=1", help="one device: dp=1 only")
    p.add_argument("--max_epoch", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--scheduler", default="constantlr")
    p.add_argument("--warmup_steps", type=int, default=2500)
    p.add_argument("--grad_clip", type=float, default=5.0)
    p.add_argument("--accum_grad", type=int, default=2)
    p.add_argument("--bf16_moments", action="store_true", help="store adam's first moment in bf16")
    p.add_argument("--max_frames_in_batch", type=int, default=2000)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--save_per_step", type=int, default=-1)
    p.add_argument("--use_spk_embedding", action="store_true")
    p.add_argument("--dpo", action="store_true", help="DPO fine-tuning (llm only): the JAX CLI never reads it; raises")
    p.add_argument("--seed", type=int, default=1986)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if any(n != 1 for n in parse_mesh(args.mesh).values()):
        raise NotImplementedError(f"--mesh {args.mesh}: fangyan_tts_torch trains on one device; multi-device "
                                  "training (the JAX package's parallel/ mesh) is not ported yet")
    if args.dpo:
        raise NotImplementedError("--dpo: the JAX CLI parses this flag and never reads it; DPO is the library "
                                  "fangyan_tts_torch.train.dpo (make_dpo_train_step)")
    if args.model == "hifigan":
        raise SystemExit("hifigan training: use fangyan_tts_torch.cli.train_gan")

    import torch

    from ..config import CosyVoiceConfig, config_from_dict
    from ..data.dataset import build_pipeline, make_mel_fn, stack_microbatches
    from ..models.flow import CausalMaskedDiffWithDiT, flow_train_draws
    from ..models.from_jax import convert, to_jax_tree
    from ..models.llm import CosyVoice3LM
    from ..ops.device import resolve_device
    from ..tokenizer import get_qwen_tokenizer
    from ..train import trainer
    from ..train.checkpoint import load_meta, load_params, save_params
    from ..train.executor import Executor
    from ..train.scheduler import build_optimizer

    dev = resolve_device(args.device)
    cfg = CosyVoiceConfig()
    if args.config:
        cfg = config_from_dict(json.loads(Path(args.config).read_text()))
    tokenizer = get_qwen_tokenizer(args.tokenizer_path or args.qwen_pretrain_path or None)
    mel_fn = make_mel_fn(dev) if args.model == "flow" else None

    tx = build_optimizer(
        optim="adam", lr=args.lr, scheduler=args.scheduler,
        scheduler_conf={"warmup_steps": args.warmup_steps} if args.scheduler == "warmuplr" else None,
        grad_clip=args.grad_clip,
        moments_dtype="bfloat16" if args.bf16_moments else None,
    )
    if args.model == "llm":
        model = trainer.random_module(lambda: CosyVoice3LM(cfg.llm, dtype=torch.bfloat16), args.seed, dev)
        step_fn = trainer.make_llm_train_step(model, tx, accum=args.accum_grad)
    else:
        model = trainer.random_module(lambda: CausalMaskedDiffWithDiT(cfg.flow), args.seed, dev)
        step_fn = trainer.make_flow_train_step(model, tx, accum=args.accum_grad)

    start_epoch, start_step = 0, 0
    if args.checkpoint:
        model.load_state_dict(convert(load_params(args.checkpoint), model), strict=True)
        meta = load_meta(args.checkpoint) or {}
        start_epoch = int(meta.get("epoch", -1)) + 1
        start_step = int(meta.get("step", 0))
        print(f"resumed from {args.checkpoint} (epoch {start_epoch}, step {start_step})")

    state = trainer.init_state(model, tx)
    state.step = start_step
    save_init = Path(args.model_dir) / "init.msgpack"
    if not save_init.exists():
        save_params(save_init, to_jax_tree(model.state_dict(), model), meta={"epoch": -1, "step": 0})

    executor = Executor(step_fn, args.model_dir, args.log_interval, args.save_per_step)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def make_data(epoch: int, path: str, stack: bool = True):
        it = build_pipeline(
            path, tokenizer, mel_fn, mode=args.model, llm_cfg=cfg.llm,
            epoch=epoch, max_frames_in_batch=args.max_frames_in_batch,
            use_spk_embedding=args.use_spk_embedding,
        )
        if stack and args.accum_grad > 1:
            it = stack_microbatches(it, args.accum_grad)
        return it

    def cv_fn(m, batch):
        if args.model == "llm":
            loss, acc = m(*(torch.as_tensor(batch[k], device=dev) for k in trainer.LLM_KEYS))
            return {"loss": loss, "acc": acc}
        inputs = [torch.as_tensor(batch[k], device=dev) for k in trainer.FLOW_KEYS]
        feat = inputs[2]  # every CV batch draws from seed 0, as the JAX CLI's PRNGKey(0)
        draws = flow_train_draws(feat.shape[0], feat.shape, dev, torch.Generator(device=dev).manual_seed(0))
        loss, _ = m(*inputs, draws)
        return {"loss": loss}

    cv = _Reiterable(lambda: make_data(0, args.cv_data, stack=False)) if args.cv_data else None
    for epoch in range(start_epoch, args.max_epoch):
        state, gen = executor.train_one_epoch(state, make_data(epoch, args.train_data), epoch, gen, cv, cv_fn)
        print(f"epoch {epoch} done, step {int(state.step)}")


if __name__ == "__main__":
    main()
