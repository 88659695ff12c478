"""Model export, the port's copy of fangyan_tts_tpu/cli/export.py (after the
reference's export_jit.py / export_onnx.py).

The JAX CLI serializes StableHLO programs (jax.export); the port's artifact
is a torch.export program saved with `torch.export.save` (`<name>.pt2`), one
for each inference stage at the JAX CLI's shapes, plus the three parameter
trees as flax msgpack in the JAX package's layout:

- `flow_prepare.pt2`: CausalMaskedDiffWithDiT.prepare_inference(finalize=True)
  on token (1, nt), token_len, prompt_feat (1, 2nt, 80), prompt_feat_len,
  embedding (1, 192) -> (mu, spks, conds, mel_len);
- `flow_solve.pt2`: models/flow.cfm_solve (full attention) on the DiT over
  z, mu (1, 2nt, 80), spks (1, 80), conds (1, 2nt, 80), mel_len (1,);
- `vocoder.pt2`: CausalHiFT(mel (1, 2nt, 80), finalize=True)[0].

Each program holds the weights of the submodules it runs and no others. On
CUDA the DiT's attention is the custom op `fangyan::chunk_flash_attention`
(ops/flash_attention.py): a loaded `flow_solve` launches the flash kernel,
`n_timesteps x depth` times a call, once `fangyan_tts_torch` is imported
(which registers the op). All three are written before `--check` loads each
file back and holds it to the eager call, in float32, at atol 1e-3. It runs
on CUDA unless --device cpu.

python -m fangyan_tts_torch.cli.export --model_dir <dir> --output_dir exported/ [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
import torch.nn as nn

CHECK_ATOL = 1e-3


class FlowPrepare(nn.Module):
    """prepare_inference(finalize=True) on the flow's embedding, speaker
    projection and lookahead layer only (not the DiT)."""

    def __init__(self, flow):
        super().__init__()
        self.cfg = flow.cfg
        self.input_embedding = flow.input_embedding
        self.spk_embed_affine_layer = flow.spk_embed_affine_layer
        self.pre_lookahead_layer = flow.pre_lookahead_layer

    def forward(self, token, token_len, prompt_feat, prompt_feat_len, embedding):
        from ..models.flow import CausalMaskedDiffWithDiT

        return CausalMaskedDiffWithDiT.prepare_inference(self, token, token_len, prompt_feat, prompt_feat_len,
                                                         embedding, finalize=True)


class FlowSolve(nn.Module):
    """cfm_solve with full attention (streaming=False) on the DiT."""

    def __init__(self, flow):
        super().__init__()
        self.cfg = flow.cfg
        self.estimator = flow.estimator

    def forward(self, z, mu, spks, conds, mel_len):
        from ..models.flow import cfm_solve

        return cfm_solve(self.cfg, self.estimator, z, mu, spks, conds, mel_len, False)


class Vocoder(nn.Module):
    """CausalHiFT(mel, finalize=True)[0]: the audio."""

    def __init__(self, hift):
        super().__init__()
        self.hift = hift

    def forward(self, mel):
        return self.hift(mel, finalize=True)[0]


def programs(tts, n_tokens: int) -> list[tuple[str, nn.Module, tuple]]:
    """(name, module, example inputs) of the three programs at the JAX CLI's
    shapes (zeros, prompt_feat_len 0, mel_len 2 * n_tokens) in the model's
    dtype on its device."""
    dev, dt, nt = tts.device, tts.dtype, n_tokens
    i32 = dict(dtype=torch.int32, device=dev)
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
    prep = (torch.zeros((1, nt), **i32), torch.tensor([nt], **i32), zeros(1, 2 * nt, 80), torch.tensor([0], **i32),
            zeros(1, 192))
    solve = (zeros(1, 2 * nt, 80), zeros(1, 2 * nt, 80), zeros(1, 80), zeros(1, 2 * nt, 80),
             torch.tensor([2 * nt], **i32))
    return [("flow_prepare", FlowPrepare(tts.flow), prep), ("flow_solve", FlowSolve(tts.flow), solve),
            ("vocoder", Vocoder(tts.hift), (zeros(1, 2 * nt, 80),))]


def max_diff(a, b) -> float:
    """max |a - b| in float32 over matching leaves of two outputs."""
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    assert len(a) == len(b)
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def as_jax_holds(tree: dict, dtype: torch.dtype, keep_f32: tuple[str, ...] = ()) -> dict:
    """A JAX-layout tree as the JAX package's CosyVoice3 holds it: every
    floating leaf of two or more dimensions in `dtype`, the stacked layers'
    vectors included (the port keeps those per layer, in float32), except
    under the top-level keys `keep_f32`."""
    def cast(t):  # to_jax_tree's leaves: numpy arrays, or torch tensors where numpy has no dtype
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        t = torch.as_tensor(t)
        return t.to(dtype) if t.is_floating_point() and t.dim() >= 2 else t

    return {k: v if k in keep_f32 else cast(v) for k, v in tree.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--n_tokens", type=int, default=256, help="flow bucket (tokens)")
    p.add_argument("--check", action="store_true", help="roundtrip parity check of each saved program")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..api import CosyVoice3
    from ..models.from_jax import to_jax_tree
    from ..train.checkpoint import save_params

    model = CosyVoice3(args.model_dir, load_frontend_models=False, device=args.device)
    tts = model.model
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    progs = programs(tts, args.n_tokens)
    with torch.no_grad():
        for name, module, eargs in progs:
            t0 = time.perf_counter()
            ep = torch.export.export(module.eval(), eargs)
            path = out / f"{name}.pt2"
            torch.export.save(ep, path)
            print(f"exported {name} -> {path} ({path.stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        for name, module, eargs in progs if args.check else ():
            got = torch.export.load(out / f"{name}.pt2").module()(*eargs)
            err = max_diff(got, module(*eargs))
            if not err <= CHECK_ATOL:
                raise AssertionError(f"{name}: the loaded program differs from the eager call by {err}")
            print(f"  {name}: parity check OK (max |diff| {err:.3g})", flush=True)

    for name, module, keep in (("llm", tts.llm, ()), ("flow", tts.flow, ()), ("hift", tts.hift, ("f0_predictor",))):
        save_params(out / f"{name}.msgpack", as_jax_holds(to_jax_tree(module.state_dict(), module), tts.dtype, keep))
    print(f"✅ export complete: {out}")


if __name__ == "__main__":
    main()
