"""HiFiGAN vocoder training CLI (fangyan_tts_tpu/cli/train_gan.py, the
reference's bin/train.py --model hifigan), with the JAX CLI's flags and
defaults plus --device.

python -m fangyan_tts_torch.cli.train_gan \
    --train_data data.list --model_dir exp/hifigan [--config conf.json] \
    [--max_epoch 200] [--device cuda|cpu] ...

Trains the CosyVoice3 vocoder (CausalHiFT, float32) against the
MultipleDiscriminator, CUDA unless --device cpu, from the
parquet shards that data prep writes (data/dataset.build_pipeline in
hifigan mode: 24,960-sample crops, their matcha mels on the device and
their f0). Each batch takes a discriminator turn and then a generator
turn, each its own optax.adam (train/gan.py). Weights start from the JAX
package's fast-init rules with --seed (the discriminator with --seed + 1).
Each epoch writes epoch_N_whole.msgpack (the generator, which
api.AutoModel's CausalHiFT loads) and epoch_N_disc.msgpack, both in the
JAX package's layout with an {"epoch": N} sidecar. --mesh
dp=..,fsdp=..,tp=.. under torchrun trains data-parallel with replicated
models (train/gan.shard_gan_state; every process reads the same batches
and takes its rows over dp x fsdp); process 0 alone prints and writes.
Without torchrun a mesh past one process raises.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--train_data", required=True)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr_d", type=float, default=2e-4)
    p.add_argument("--max_epoch", type=int, default=200)
    p.add_argument("--max_frames_in_batch", type=int, default=2000)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=1986)
    p.add_argument("--mesh", default="dp=1", help="dp=..,fsdp=..,tp=.. (under torchrun: their product processes)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..config import CosyVoiceConfig, config_from_dict
    from ..data.dataset import build_pipeline, make_mel_fn
    from ..models import discriminators
    from ..models.hift import CausalHiFT
    from ..ops.device import exact_fp32, resolve_device
    from ..parallel.mesh import make_mesh
    from ..tokenizer import get_qwen_tokenizer
    from ..train.checkpoint import save_module
    from ..train.gan import init_gan_state, make_hifigan_steps, shard_gan_state
    from ..train.scheduler import plain_adam
    from ..train.trainer import random_module
    from .train import parse_mesh

    dev = resolve_device(args.device)
    mesh = make_mesh(**parse_mesh(args.mesh), device=dev)
    main_rank = mesh.size == 1 or torch.distributed.get_rank() == 0
    if dev.type == "cuda":
        exact_fp32()  # the STFTs and the f0 predictor need float32 products
    cfg = CosyVoiceConfig()
    if args.config:
        cfg = config_from_dict(json.loads(Path(args.config).read_text()))

    hift = random_module(lambda: CausalHiFT(cfg.hift), args.seed, dev)
    disc = random_module(discriminators.MultipleDiscriminator, args.seed + 1, dev)
    gen_tx, disc_tx = plain_adam(args.lr), plain_adam(args.lr_d)
    state = init_gan_state(hift, disc, gen_tx, disc_tx)
    if mesh.size > 1:
        state = shard_gan_state(state, mesh)
    gen_step, disc_step = make_hifigan_steps(hift, disc, gen_tx, disc_tx, mesh=mesh if mesh.size > 1 else None)

    tokenizer = get_qwen_tokenizer(args.tokenizer_path)
    mel_fn = make_mel_fn(dev)
    model_dir = Path(args.model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)

    for epoch in range(args.max_epoch):
        data = build_pipeline(args.train_data, tokenizer, mel_fn, mode="hifigan", epoch=epoch,
                              max_frames_in_batch=args.max_frames_in_batch)
        for i, batch in enumerate(data):
            if len(batch["speech"]) < mesh.data_size:  # an epoch's last few crops cannot split over the data ranks
                continue
            # alternating turns (the reference's executor): the discriminator, then the generator, each batch
            state, dm = disc_step(state, batch)
            state, gm = gen_step(state, batch)
            if i % args.log_interval == 0 and main_rank:
                print(f"epoch {epoch} it {i} gen={float(gm['loss']):.4f} mel={float(gm['loss_mel']):.4f} "
                      f"disc={float(dm['loss']):.4f}", flush=True)
        if main_rank:
            save_module(model_dir / f"epoch_{epoch}_whole.msgpack", hift, meta={"epoch": epoch})
            save_module(model_dir / f"epoch_{epoch}_disc.msgpack", disc, meta={"epoch": epoch})
            print(f"epoch {epoch} done")
    if mesh.size > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
