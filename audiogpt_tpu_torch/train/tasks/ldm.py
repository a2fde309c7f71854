"""Latent-diffusion (Make-An-Audio-class) training task — the T2A trainer.

Counterpart of ``audiogpt_tpu/train/tasks/ldm.py``. Reference:
``LatentDiffusion_audio`` (``ldm/models/diffusion/ddpm_audio.py``:
``p_losses``:682 — sample t, noise the VAE latent, predict ε, L2 with
conditioning from the frozen CLAP text tower; first stage and cond stage
frozen, the UNet trains).

Batch schema, as JAX's: {"mels": [B, H, W, 1] VAE-domain ([-1, 1]) mel
images, "text_ids": [B, L], "text_mask": [B, L], "weight": [B]}. The
modules are grouped as ``{"unet": ..., "frozen": {"vae", "clap"}}``, the
JAX param tree's layout, so :meth:`LDMTask.load_jax_params` maps it
straight across. The frozen stages run in eval mode under ``no_grad`` with
``requires_grad`` off (JAX's ``stop_gradient``): no optimizer state, no
EMA and no checkpoint space for them.

``bf16_compute``: every f32 UNet parameter is cast to bf16 inside the loss
(``torch.func.functional_call``, so the gradients flow through the cast
into the f32 masters), ``z_t`` and the context go in as bf16 and ε comes
back as f32; GroupNorm keeps f32 statistics and the time embedding stays
f32, as in JAX. The flash kernel's bf16 entry runs the level-0
attention. ``torch.autocast`` rounds at other points and is not the
counterpart. With ``unet.use_checkpoint`` too, each checkpointed block
takes the bf16 parameters as inputs (``models/diffusion/unet.py``), so
its recompute in the backward runs on the same bf16 tensors as its
forward (JAX: ``nn.remat`` under the cast).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.diffusion import (AutoencoderKL,
                                                 DiffusionSchedule,
                                                 UNetConfig, UNetModel,
                                                 VAEConfig)
from audiogpt_tpu_torch.models.textenc import CLAPTextConfig, CLAPTextEncoder
from audiogpt_tpu_torch.parallel.reduce import (global_mean, global_rows,
                                                global_sums, local_rows)
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


@dataclasses.dataclass(frozen=True)
class LDMTaskConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    clap: CLAPTextConfig = CLAPTextConfig()
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    scale_factor: float = 1.0
    loss_type: str = "l2"             # ddpm_audio.py default
    cond_drop_prob: float = 0.1       # classifier-free guidance training
    train_cond_stage: bool = False    # reference freezes CLAP
    #: mixed precision: the UNet forward and backward in bfloat16 (params
    #: cast inside the loss; master weights, optimizer state, GroupNorm
    #: statistics and the loss stay f32)
    bf16_compute: bool = False
    optim: OptimConfig = OptimConfig(
        optimizer="adamw", lr=1e-4, schedule="constant", beta1=0.9,
        beta2=0.999, clip_grad_norm=1.0,
        ema_decay=0.9999)  # reference trains with use_ema (ddpm.py:43)


class LDMTask:
    """Groups: only 'unet' optimizes (VAE and CLAP frozen, the reference's
    behaviour). ``params``: the JAX task's tree (numpy leaves) to load;
    ``None`` keeps a seeded random init. ``device=None`` is the card, and
    raises without one."""

    def __init__(self, cfg: LDMTaskConfig, params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        if cfg.train_cond_stage:
            # the JAX task keeps the flag but never optimizes the tower
            raise NotImplementedError("train_cond_stage: the CLAP tower "
                                      "trains in no recipe")
        self.cfg = cfg
        self.device = resolve_device(device)
        unet = seeded(rng_seed, lambda: UNetModel(cfg.unet))
        vae = seeded(rng_seed + 1, lambda: AutoencoderKL(cfg.vae))
        clap = seeded(rng_seed + 2, lambda: CLAPTextEncoder(cfg.clap))
        frozen = nn.ModuleDict({"vae": vae, "clap": clap})
        frozen.eval().requires_grad_(False)
        self._modules = {"unet": unet.to(self.device),
                         "frozen": frozen.to(self.device)}
        if params is not None:
            self.load_jax_params(params)
        self.schedule = DiffusionSchedule.linear(
            cfg.timesteps, cfg.linear_start, cfg.linear_end)
        #: the dtype of the UNet's arithmetic (the trainer's MFU peak)
        self.compute_dtype = torch.bfloat16 if cfg.bf16_compute \
            else torch.float32

    @property
    def unet(self) -> UNetModel:
        return self._modules["unet"]

    @property
    def vae(self) -> AutoencoderKL:
        return self._modules["frozen"]["vae"]

    @property
    def clap(self) -> CLAPTextEncoder:
        return self._modules["frozen"]["clap"]

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"unet", "frozen": {"vae", "clap"}}`` tree
        (numpy leaves), strictly."""
        load_jax_params(self.unet, params["unet"])
        for key in ("vae", "clap"):
            load_jax_params(self._modules["frozen"][key],
                            params["frozen"][key])

    def draws(self, shape: tuple,
              generator: torch.Generator | None) -> dict:
        """The loss's four draws for latents of ``shape`` [B, z, h, w] from
        ``generator``: the posterior's normals, the CFG drop, the timesteps
        and the noise (JAX: ``split(rng, 4)``); made for the global batch
        and cut to this rank's rows."""
        b, dev = global_rows(shape[0]), self.device
        shape = (b, *shape[1:])
        draws = {
            "post": torch.randn(shape, generator=generator, device=dev),
            "drop": torch.rand(b, generator=generator, device=dev)
            < self.cfg.cond_drop_prob,
            "t": torch.randint(0, self.cfg.timesteps, (b,),
                               generator=generator, device=dev),
            "noise": torch.randn(shape, generator=generator, device=dev)}
        return {k: local_rows(v) for k, v in draws.items()}

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None,
             draws: Mapping[str, torch.Tensor] | None = None):
        """→ (loss, {"diff", "total_loss"}). ``draws`` (``post`` and
        ``noise`` [B, z, h, w], ``drop`` [B] bool, ``t`` [B] int) replaces
        the four draws of :meth:`draws`; without it they come from
        ``generator``."""
        cfg = self.cfg
        with torch.no_grad():
            post = self.vae.encode(batch["mels"].permute(0, 3, 1, 2).float())
            if draws is None:
                draws = self.draws(tuple(post.mean.shape), generator)
            z0 = post.sample(draws["post"]) * cfg.scale_factor
            mask = batch.get("text_mask")
            ctx = self.clap(batch["text_ids"].long(),
                            None if mask is None else mask.long())
            # CFG training: drop the conditioning of a fraction of items
            ctx = torch.where(draws["drop"][:, None, None], 0.0, ctx)
        noise, t = draws["noise"], draws["t"]
        z_t = self.schedule.q_sample(z0, t, noise)
        if cfg.bf16_compute:
            params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32
                      else p for n, p in self.unet.named_parameters()}
            eps = torch.func.functional_call(
                self.unet, params, (z_t.to(torch.bfloat16), t,
                                    ctx.to(torch.bfloat16)))
        else:
            eps = self.unet(z_t, t, ctx)
        eps = eps.float()
        err = (eps - noise) ** 2 if cfg.loss_type == "l2" \
            else (eps - noise).abs()
        w = batch.get("weight")
        if w is not None:
            # the global batch's weight: every rank's rows (JAX's denom)
            num, wsum = global_sums((err * w[:, None, None, None]).sum(),
                                    w.sum())
            loss = num / torch.clamp(wsum * noise[0].numel(), min=1.0)
        else:
            loss = global_mean(err)
        return loss, {"diff": loss.detach(), "total_loss": loss.detach()}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return self._modules

    @property
    def loss_fns(self) -> Mapping[str, object]:
        return {"unet": self.loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"unet": self.cfg.optim}
