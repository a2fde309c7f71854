"""VISinger (VITS-class SVS) training task (two optimized groups).

Counterpart of ``audiogpt_tpu/train/tasks/visinger.py``: the VITS
objective, KL(posterior ‖ flow(prior)) + the duration loss + the
log-magnitude STFT L1 at (1024, 256, 1024) + LSGAN + feature matching
through the HiFi-GAN discriminators (``models/vocoder/discriminators.py``),
as the vocoder recipe has them. The trainer runs the groups in the order
of :attr:`loss_fns`, ``disc`` then ``model``, each one's gradient with
respect to its own parameters only.

As JAX's ``stop_gradient`` does, the ``disc`` step runs the generator under
``no_grad``; the ``model`` step reads the critic's logits and feature maps
of the fake wav through the live critic (the gradient reaches the wav; the
critic is not in the group, so no step moves it) and the real wav's
feature maps under ``no_grad``. The one draw, the posterior's ε
[B, F, latent], is drawn in each group from the trainer's generator, which
both groups seed alike, as JAX's two ``_forward`` calls take the step's one
key; or it is replayed (``draws=``).

Batch schema: {"txt_tokens", "pitch_midi", "is_slur", "mel2ph", "spec"
[B, F, bins] linear magnitude, "wav" [B, F·hop], "weight"} (``collate_tts``
with ``wav_hop``). The decoder runs on the whole z sequence, so a step's
wav is the batch's whole mel length · hop.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.svs.visinger import VISinger, VISingerConfig
from audiogpt_tpu_torch.models.vocoder.discriminators import (
    DiscriminatorConfig, HifiGANDiscriminator, feature_matching_loss,
    lsgan_d_loss, lsgan_g_loss)
from audiogpt_tpu_torch.parallel.reduce import global_rows, local_rows
from audiogpt_tpu_torch.train import losses as L
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.train.stft_loss import stft_loss
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

#: the one STFT resolution of the magnitude loss
_RESOLUTION = ((1024, 256, 1024),)


@dataclasses.dataclass(frozen=True)
class VISingerTaskConfig:
    model: VISingerConfig = VISingerConfig()
    disc: DiscriminatorConfig = DiscriminatorConfig()
    lambda_kl: float = 1.0
    lambda_mel: float = 45.0
    lambda_fm: float = 2.0
    lambda_adv: float = 1.0
    lambda_dur: float = 0.1
    optim_model: OptimConfig = OptimConfig(
        optimizer="adamw", lr=2e-4, schedule="exponential", beta1=0.8,
        beta2=0.99, lr_decay=0.999, lr_decay_every=1000, clip_grad_norm=0.0)
    optim_disc: OptimConfig = OptimConfig(
        optimizer="adamw", lr=2e-4, schedule="exponential", beta1=0.8,
        beta2=0.99, lr_decay=0.999, lr_decay_every=1000, clip_grad_norm=0.0)


class VISingerTask:
    """Groups ``disc`` and ``model``. ``params``: the JAX task's ``{"model",
    "disc"}`` tree (numpy leaves) to load; ``None`` keeps a seeded random
    init. ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: VISingerTaskConfig,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: VISinger(cfg.model)).to(
            self.device)
        self.disc = seeded(rng_seed + 1,
                           lambda: HifiGANDiscriminator(cfg.disc)).to(
            self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"model", "disc"}`` tree, strictly."""
        load_jax_params(self.model, params["model"])
        load_jax_params(self.disc, params["disc"])

    def draws(self, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator | None) -> torch.Tensor:
        """The posterior's ε [B, F, latent] for ``batch``'s spec (drawn
        for the global batch, cut to this rank's rows)."""
        spec = batch["spec"]
        return local_rows(torch.randn(
            (global_rows(spec.shape[0]), spec.shape[1],
             self.cfg.model.latent_dim), generator=generator,
            device=spec.device))

    def forward(self, batch: Mapping[str, torch.Tensor],
                draws: torch.Tensor | torch.Generator) -> dict:
        """``VISinger.train_step_outputs`` on the batch."""
        return self.model.train_step_outputs(
            batch["txt_tokens"].long(), batch["pitch_midi"].long(),
            batch["is_slur"].long(), batch["mel2ph"].long(), batch["spec"],
            draws)

    def model_loss(self, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   draws: torch.Tensor | None = None):
        """→ (total, {kl, mel, adv, fm, pdur, total_loss})."""
        cfg = self.cfg
        if draws is None:
            draws = self.draws(batch, generator)
        out = self.forward(batch, draws)
        fake, real = out["wav"], batch["wav"]
        fake_logits, fake_fmaps = self.disc(fake)
        with torch.no_grad():
            _, real_fmaps = self.disc(real)
        _, mag = stft_loss(fake, real, resolutions=_RESOLUTION)
        metrics = {
            "kl": out["kl"] * cfg.lambda_kl,
            "mel": mag * cfg.lambda_mel,
            "adv": lsgan_g_loss(fake_logits) * cfg.lambda_adv,
            "fm": feature_matching_loss(real_fmaps, fake_fmaps)
            * cfg.lambda_fm,
        }
        metrics.update(L.dur_loss(out["dur"], batch["mel2ph"].long(),
                                  batch["txt_tokens"], batch.get("weight"),
                                  lambda_ph=cfg.lambda_dur, lambda_sent=0.0))
        total = sum(metrics.values())
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return total, metrics

    def disc_loss(self, batch: Mapping[str, torch.Tensor],
                  generator: torch.Generator | None = None,
                  draws: torch.Tensor | None = None):
        """→ (loss, {d_loss}); the generator runs under ``no_grad``."""
        if draws is None:
            draws = self.draws(batch, generator)
        with torch.no_grad():
            fake = self.forward(batch, draws)["wav"]
        real_logits, _ = self.disc(batch["wav"])
        fake_logits, _ = self.disc(fake)
        loss = lsgan_d_loss(real_logits, fake_logits)
        return loss, {"d_loss": loss.detach()}

    def val_loss_fn(self, batch: Mapping[str, torch.Tensor],
                    generator: torch.Generator | None = None):
        out = self.forward(batch, self.draws(batch, generator))
        _, mag = stft_loss(out["wav"], batch["wav"], resolutions=_RESOLUTION)
        return mag, {"val_mel": mag, "total_loss": mag}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"disc": self.disc, "model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        # disc first, then model: the model step sees the updated critic
        return {"disc": self.disc_loss, "model": self.model_loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"disc": self.cfg.optim_disc, "model": self.cfg.optim_model}
