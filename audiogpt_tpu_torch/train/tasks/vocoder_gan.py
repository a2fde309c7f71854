"""HiFi-GAN vocoder GAN training task (two optimized groups).

Counterpart of ``audiogpt_tpu/train/tasks/vocoder_gan.py`` (the reference's
``VocoderBaseTask``, ``NeuralSeq/tasks/vocoder/vocoder_base.py:13``, with
the HiFi-GAN recipe of ``modules/hifigan/hifigan.py``): a discriminator
step (MPD + MSD, LSGAN) then a generator step (LSGAN adversarial + feature
matching + the log-magnitude L1 at 1024/256, optionally the
multi-resolution STFT loss) on each batch, AdamW(0.8, 0.99) with an
exponential decay. The trainer runs the groups in the order of
:attr:`loss_fns`, ``disc`` then ``gen``, and takes each group's gradient
with respect to its own parameters only.

As JAX's ``stop_gradient`` does, the discriminator step runs the generator
under ``no_grad``, and the generator step computes the real wav's feature
maps under ``no_grad`` (their gradient is zero; keeping their graph would
only hold memory). The generator gets the batch's f0 when it has one (NSF).

Batch schema: {"mels": [B, F, M], "wav": [B, F·hop], "weight": [B]}.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.vocoder.discriminators import (
    DiscriminatorConfig, HifiGANDiscriminator, feature_matching_loss,
    lsgan_d_loss, lsgan_g_loss)
from audiogpt_tpu_torch.models.vocoder.hifigan import (HifiGANConfig,
                                                       HifiGANGenerator)
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.train.stft_loss import stft_loss
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


@dataclasses.dataclass(frozen=True)
class VocoderGANTaskConfig:
    gen: HifiGANConfig = HifiGANConfig()
    disc: DiscriminatorConfig = DiscriminatorConfig()
    lambda_adv: float = 1.0
    lambda_fm: float = 2.0
    lambda_mel: float = 45.0          # hifigan's l1 mel weight
    lambda_stft: float = 0.0          # parallel_wavegan-style extra (off = ref)
    segment_frames: int = 32          # training crop, frames
    optim_gen: OptimConfig = OptimConfig(
        optimizer="adamw", lr=2e-4, schedule="exponential", beta1=0.8,
        beta2=0.99, lr_decay=0.999, lr_decay_every=1000, clip_grad_norm=0.0)
    optim_disc: OptimConfig = OptimConfig(
        optimizer="adamw", lr=2e-4, schedule="exponential", beta1=0.8,
        beta2=0.99, lr_decay=0.999, lr_decay_every=1000, clip_grad_norm=0.0)


class VocoderGANTask:
    """Groups ``disc`` and ``gen``. ``params``: the JAX task's ``{"gen",
    "disc"}`` tree (numpy leaves) to load; ``None`` keeps a seeded random
    init. ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: VocoderGANTaskConfig,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gen = seeded(rng_seed, lambda: HifiGANGenerator(cfg.gen)).to(
            self.device)
        self.disc = seeded(rng_seed + 1,
                           lambda: HifiGANDiscriminator(cfg.disc)).to(
            self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"gen", "disc"}`` tree, strictly."""
        load_jax_params(self.gen, params["gen"])
        load_jax_params(self.disc, params["disc"])

    def _fake_wav(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.gen(batch["mels"].transpose(1, 2), f0=batch.get("f0"))

    def _mel_l1(self, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        # the log-magnitude L1 at one mid resolution, as JAX's
        return stft_loss(fake, real, resolutions=((1024, 256, 1024),))[1]

    def gen_loss(self, batch: Mapping[str, torch.Tensor],
                 generator: torch.Generator | None = None):
        """→ (total, {g_adv, g_fm, g_mel[, g_stft], total_loss})."""
        cfg = self.cfg
        real = batch["wav"]
        fake = self._fake_wav(batch)
        fake_logits, fake_fmaps = self.disc(fake)
        with torch.no_grad():
            _, real_fmaps = self.disc(real)
        metrics = {"g_adv": lsgan_g_loss(fake_logits) * cfg.lambda_adv,
                   "g_fm": feature_matching_loss(real_fmaps, fake_fmaps)
                   * cfg.lambda_fm,
                   "g_mel": self._mel_l1(fake, real) * cfg.lambda_mel}
        if cfg.lambda_stft > 0:
            sc, mag = stft_loss(fake, real)
            metrics["g_stft"] = (sc + mag) * cfg.lambda_stft
        total = sum(metrics.values())
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return total, metrics

    def disc_loss(self, batch: Mapping[str, torch.Tensor],
                  generator: torch.Generator | None = None):
        """→ (loss, {d_loss})."""
        with torch.no_grad():
            fake = self._fake_wav(batch)
        real_logits, _ = self.disc(batch["wav"])
        fake_logits, _ = self.disc(fake)
        loss = lsgan_d_loss(real_logits, fake_logits)
        return loss, {"d_loss": loss.detach()}

    def val_loss_fn(self, batch: Mapping[str, torch.Tensor],
                    generator: torch.Generator | None = None):
        mel = self._mel_l1(self._fake_wav(batch), batch["wav"])
        return mel, {"val_mel_l1": mel, "total_loss": mel}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"disc": self.disc, "gen": self.gen}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        # disc first, then gen: the gen step then sees the updated critic
        return {"disc": self.disc_loss, "gen": self.gen_loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"disc": self.cfg.optim_disc, "gen": self.cfg.optim_gen}
