"""First-stage AutoencoderKL (VAE-GAN) training for the latent-diffusion
family (two optimized groups).

Counterpart of ``audiogpt_tpu/train/tasks/vae.py`` (Make-An-Audio's
``AutoencoderKL``, ``ldm/models/autoencoder.py:305``, with the
taming-transformers objective of ``ldm/modules/losses_audio/``): the L1
reconstruction, the posterior's KL per element (weighted by
``kl_weight``) and an LSGAN term from a PatchGAN critic over the mel image
(the reference's LPIPS term is image-pretrained and has no meaning for
mels). Groups ``disc`` then ``model``, as the vocoder recipe: the critic's
step reads the reconstruction under ``no_grad`` (JAX's
``stop_gradient``); the model's step reads the live critic, which is not
in its group, so no step of the model moves it.

The one draw, the posterior's sample, is drawn in each group from the
trainer's generator (both groups seed it alike, as JAX's one key a step;
for the global batch, cut to a rank's rows) or replayed (``draws=``, [B,
z, h, w]). Every mean runs over the global batch. Batch schema: {"mels":
[B, H, W, 1] in the VAE domain [−1, 1]} (``collate_mel_image``, NHWC as
JAX's; the task transposes). The VAE's one attention (the mid block's, a single head at
``ch · ch_mult[-1]`` wide) is the plain product, never the flash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.diffusion.vae import (AutoencoderKL,
                                                     GaussianMoments,
                                                     VAEConfig)
from audiogpt_tpu_torch.ops.conv import pad_same
from audiogpt_tpu_torch.parallel.reduce import (global_mean, global_rows,
                                                local_rows)
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


class PatchDiscriminator(nn.Module):
    """PatchGAN over mel images (taming's ``NLayerDiscriminator``): NCHW
    [B, 1, H, W] → patch logits [B, 1, h, w]. 4×4 convs with flax's SAME
    padding (``pad_same``: (1, 1) on an even axis and (1, 2) on an odd
    one at stride 2, (1, 2) at stride 1), stride 2 but for the last
    hidden conv and ``out``; a leaky ReLU (0.2) after each hidden conv,
    the later ones after a LayerNorm over the channels (ε = 1e-6)."""

    def __init__(self, in_channels: int = 1, hidden: int = 64,
                 layers: int = 3):
        super().__init__()
        self.layers = layers
        ch = hidden
        self.add_module("in", nn.Conv2d(in_channels, ch, 4, stride=2))
        for i in range(1, layers):
            prev, ch = ch, min(ch * 2, 512)
            stride = 2 if i < layers - 1 else 1
            self.add_module(f"conv{i}", nn.Conv2d(prev, ch, 4, stride=stride))
            self.add_module(f"norm{i}", nn.LayerNorm(ch, eps=1e-6))
        self.out = nn.Conv2d(ch, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(getattr(self, "in")(pad_same(x, 4, 2, dims=2)), 0.2)
        for i in range(1, self.layers):
            conv = getattr(self, f"conv{i}")
            x = conv(pad_same(x, 4, conv.stride[0], dims=2))
            x = getattr(self, f"norm{i}")(x.permute(0, 2, 3, 1))
            x = F.leaky_relu(x.permute(0, 3, 1, 2), 0.2)
        return self.out(pad_same(x, 4, 1, dims=2))


@dataclasses.dataclass(frozen=True)
class VAETaskConfig:
    vae: VAEConfig = VAEConfig()
    kl_weight: float = 1e-6             # txt2audio_args.yaml lossconfig
    disc_weight: float = 0.5
    optim_vae: OptimConfig = OptimConfig(
        optimizer="adam", lr=4.5e-6, schedule="constant", beta1=0.5,
        beta2=0.9, clip_grad_norm=0.0)
    optim_disc: OptimConfig = OptimConfig(
        optimizer="adam", lr=4.5e-6, schedule="constant", beta1=0.5,
        beta2=0.9, clip_grad_norm=0.0)


class VAETask:
    """Groups ``disc`` and ``model``. ``params``: the JAX task's ``{"model",
    "disc"}`` tree (numpy leaves) to load; ``None`` keeps a seeded random
    init. ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: VAETaskConfig, params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vae = seeded(rng_seed, lambda: AutoencoderKL(cfg.vae)).to(
            self.device)
        self.disc = seeded(rng_seed + 1, lambda: PatchDiscriminator(
            cfg.vae.in_channels)).to(self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"model", "disc"}`` tree, strictly."""
        load_jax_params(self.vae, params["model"])
        load_jax_params(self.disc, params["disc"])

    @staticmethod
    def _image(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return batch["mels"].permute(0, 3, 1, 2).float()

    def reconstruct(self, x: torch.Tensor,
                    draws: torch.Tensor | torch.Generator | None
                    ) -> tuple[torch.Tensor, GaussianMoments]:
        """x [B, C, H, W] → (the decoded posterior sample, the posterior);
        ``draws`` the sample's ε [B, z, h, w] or a generator."""
        post = self.vae.encode(x)
        if not isinstance(draws, torch.Tensor):
            shape = post.mean.shape
            draws = local_rows(torch.randn(
                (global_rows(shape[0]), *shape[1:]), generator=draws,
                device=post.mean.device, dtype=post.mean.dtype))
        return self.vae.decode(post.sample(draws)), post

    def model_loss(self, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   draws: torch.Tensor | None = None):
        """→ (total, {rec, kl, g_adv, total_loss}); ``kl`` is the mean
        KL over the batch per element of an image, before ``kl_weight``."""
        cfg = self.cfg
        x = self._image(batch)
        rec, post = self.reconstruct(x, generator if draws is None
                                     else draws)
        rec_loss = global_mean((x - rec).abs())
        kl = global_mean(post.kl()) / x[0].numel()
        g_adv = global_mean((self.disc(rec) - 1.0) ** 2) * cfg.disc_weight
        total = rec_loss + cfg.kl_weight * kl + g_adv
        return total, {"rec": rec_loss.detach(), "kl": kl.detach(),
                       "g_adv": g_adv.detach(), "total_loss": total.detach()}

    def disc_loss(self, batch: Mapping[str, torch.Tensor],
                  generator: torch.Generator | None = None,
                  draws: torch.Tensor | None = None):
        """→ (loss, {d_loss}): LSGAN on the real image and the detached
        reconstruction."""
        x = self._image(batch)
        with torch.no_grad():
            rec, _ = self.reconstruct(x, generator if draws is None
                                      else draws)
        loss = global_mean((self.disc(x) - 1.0) ** 2) \
            + global_mean(self.disc(rec) ** 2)
        return loss, {"d_loss": loss.detach()}

    def val_loss_fn(self, batch: Mapping[str, torch.Tensor],
                    generator: torch.Generator | None = None):
        x = self._image(batch)
        rec, _ = self.reconstruct(x, generator)
        rec_loss = global_mean((x - rec).abs())
        return rec_loss, {"val_rec": rec_loss, "total_loss": rec_loss}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"disc": self.disc, "model": self.vae}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        # disc first, then model: the model step sees the updated critic
        return {"disc": self.disc_loss, "model": self.model_loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"disc": self.cfg.optim_disc, "model": self.cfg.optim_vae}
