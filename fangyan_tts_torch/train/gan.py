"""HiFiGAN-style adversarial training of the CosyVoice3 vocoder
(fangyan_tts_tpu/train/gan.py): the losses, GANState and
`make_hifigan_steps`, which returns the alternating (generator_step,
discriminator_step).

Loss weights are the JAX package's (the reference's hifigan.py): mel 45,
feature matching 2, tpr 1 (tau 0.04), f0 L1 1, LSGAN adversarial 1.

The state's `gen_params` / `disc_params` are the modules themselves: each
turn updates its own module's parameters in place and leaves the other's
untouched. The discriminator's turn runs the generator under no_grad (the
JAX step's stop_gradient). Both optimizers are the JAX CLI's optax.adam
(train/scheduler.plain_adam). One device: a `mesh` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn as nn

from ..models.discriminators import MultipleDiscriminator
from ..models.hift import CausalHiFT
from ..ops.mel import matcha_mel
from .scheduler import Optimizer
from .trainer import check_mesh, grads_of, optimizer_apply

GAN_KEYS = ("speech", "speech_feat", "pitch_feat")


def generator_adv_loss(disc_outputs) -> torch.Tensor:
    """LSGAN generator loss: sum over the discriminators of mean((1 - D(G))^2)."""
    return sum(torch.mean((1.0 - dg) ** 2) for dg in disc_outputs)


def discriminator_adv_loss(disc_real, disc_gen) -> torch.Tensor:
    """LSGAN: sum over the discriminators of mean((1 - D(x))^2) + mean(D(G)^2)."""
    return sum(torch.mean((1.0 - dr) ** 2) + torch.mean(dg**2) for dr, dg in zip(disc_real, disc_gen))


def feature_match_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median over every element: the mean of the two middle order
    statistics for an even count (torch.median returns the lower one)."""
    s = x.flatten().sort().values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def tpr_loss(disc_real, disc_gen, tau: float = 0.04) -> torch.Tensor:
    """Truncated pointwise relativistic loss (the reference's losses.py)."""
    loss = 0.0
    for dr, dg in zip(disc_real, disc_gen):
        diff = dr - dg
        m = median(diff)
        mask = dr < dg + m
        sq = ((diff - m) ** 2) * mask
        l_rel = torch.sum(sq) / torch.clamp(mask.sum(), min=1)
        loss = loss + tau - torch.relu(tau - l_rel)
    return loss


def mel_l1_loss(real: torch.Tensor, gen: torch.Tensor) -> torch.Tensor:
    """L1 between the 24 kHz training mels (ops/mel.matcha_mel) of both
    signals, cut to a multiple of the 480-sample hop."""
    n = min(real.shape[-1], gen.shape[-1]) // 480 * 480
    return torch.mean(torch.abs(matcha_mel(gen[:, :n]) - matcha_mel(real[:, :n])))


@dataclass
class GANState:
    step: int
    gen_params: CausalHiFT  # trained in place
    disc_params: MultipleDiscriminator  # trained in place
    gen_opt: Any
    disc_opt: Any


def init_gan_state(gen: nn.Module, disc: nn.Module, gen_tx: Optimizer, disc_tx: Optimizer) -> GANState:
    return GANState(0, gen, disc, gen_tx.init(list(gen.parameters())), disc_tx.init(list(disc.parameters())))


def make_hifigan_steps(
    hift: CausalHiFT,
    disc: MultipleDiscriminator,
    gen_tx: Optimizer,
    disc_tx: Optimizer,
    mel_weight: float = 45.0,
    fm_weight: float = 2.0,
    tpr_weight: float = 1.0,
    tpr_tau: float = 0.04,
    mesh=None,
) -> tuple[Callable, Callable]:
    """Returns (generator_step, discriminator_step), each step(state, batch)
    -> (state, metrics). batch: speech (B, T), speech_feat (B, L, 80),
    pitch_feat (B, L), numpy or tensors (moved to the generator's device)."""
    check_mesh(mesh)
    dev = next(hift.parameters()).device

    def inputs(batch):
        return [torch.as_tensor(batch[k], device=dev) for k in GAN_KEYS]

    def cut(real, gen_audio):
        n = min(real.shape[1], gen_audio.shape[1])
        return real[:, :n], gen_audio[:, :n]

    def generator_step(state: GANState, batch):
        speech, feat, pitch = inputs(batch)
        gen_audio, gen_f0 = state.gen_params.forward_train(feat)
        real, gen_audio = cut(speech, gen_audio)
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = state.disc_params(real, gen_audio)
        l_gen = generator_adv_loss(y_d_gs)
        l_fm = feature_match_loss(fmap_rs, fmap_gs)
        l_mel = mel_l1_loss(real, gen_audio)
        l_tpr = tpr_loss(y_d_gs, y_d_rs, tpr_tau) if tpr_weight != 0 else 0.0
        l_f0 = torch.mean(torch.abs(gen_f0 - pitch))
        loss = l_gen + fm_weight * l_fm + mel_weight * l_mel + tpr_weight * l_tpr + l_f0
        gen_opt = optimizer_apply(state.gen_params, gen_tx, grads_of(state.gen_params, loss), state.gen_opt)
        metrics = {"loss": loss, "loss_gen": l_gen, "loss_fm": l_fm, "loss_mel": l_mel, "loss_f0": l_f0}
        new = GANState(state.step + 1, state.gen_params, state.disc_params, gen_opt, state.disc_opt)
        return new, {k: v.detach() for k, v in metrics.items()}

    def discriminator_step(state: GANState, batch):
        speech, feat, _ = inputs(batch)
        with torch.no_grad():
            gen_audio, _ = state.gen_params.forward_train(feat)
        real, gen_audio = cut(speech, gen_audio)
        y_d_rs, y_d_gs, _, _ = state.disc_params(real, gen_audio)
        l_disc = discriminator_adv_loss(y_d_rs, y_d_gs)
        l_tpr = tpr_loss(y_d_rs, y_d_gs, tpr_tau) if tpr_weight != 0 else 0.0
        loss = l_disc + tpr_weight * l_tpr
        disc_opt = optimizer_apply(state.disc_params, disc_tx, grads_of(state.disc_params, loss), state.disc_opt)
        new = GANState(state.step, state.gen_params, state.disc_params, state.gen_opt, disc_opt)
        return new, {"loss": loss.detach(), "loss_disc": l_disc.detach()}

    return generator_step, discriminator_step
