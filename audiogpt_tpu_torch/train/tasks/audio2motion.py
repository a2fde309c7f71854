"""Audio → landmark-motion VAE training task (GeneFace-class generator).

Counterpart of ``audiogpt_tpu/train/tasks/audio2motion.py`` (the
reference's GeneFace trainer is absent from its tree; the objective is the
paper's variational generator): the motion reconstruction L1, the
KL(q(z | motion, audio) ‖ p(z | audio)) and the L1 of the first
differences (velocity), each averaged over the real rows, the video
frames and the channels.

The model is built with its posterior (``motion_enc``, ``post_head``), the
JAX task's tree; its one draw, the posterior's ε [B, T_v, latent], comes
from the trainer's generator or is replayed (``draws=``). Batch schema:
``{"mels" [B, T_mel, M], "motion" [B, T_v, 136], "weight" [B]}`` with
``T_v = Audio2MotionConfig.video_len(T_mel)`` (``collate_motion``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.face.audio2motion import (Audio2MotionConfig,
                                                         Audio2MotionVAE,
                                                         kl_gauss)
from audiogpt_tpu_torch.parallel.reduce import (global_rows, global_sums,
                                                local_rows)
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


@dataclasses.dataclass(frozen=True)
class Audio2MotionTaskConfig:
    model: Audio2MotionConfig = Audio2MotionConfig()
    lambda_kl: float = 0.02
    lambda_vel: float = 0.5
    optim: OptimConfig = OptimConfig()


class Audio2MotionTask:
    """One optimized group, ``model``. ``params``: the JAX task's tree
    (numpy leaves, with the posterior) to load; ``None`` keeps a seeded
    random init. ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: Audio2MotionTaskConfig,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: Audio2MotionVAE(
            cfg.model, posterior=True)).to(self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"model": ...}`` tree, strictly."""
        load_jax_params(self.model, params["model"])

    def draws(self, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator | None) -> torch.Tensor:
        """The posterior's ε [B, T_v, latent] for ``batch``'s motion (drawn
        for the global batch, cut to this rank's rows)."""
        motion = batch["motion"]
        return local_rows(torch.randn(
            (global_rows(motion.shape[0]), motion.shape[1],
             self.cfg.model.latent), generator=generator,
            device=motion.device))

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None,
             draws: torch.Tensor | None = None):
        """→ (total, {recon_loss, kl_loss, vel_loss, total_loss})."""
        cfg = self.cfg
        mels, motion = batch["mels"], batch["motion"]
        if draws is None:
            draws = self.draws(batch, generator)
        recon, (mu_q, lv_q), (mu_p, lv_p) = self.model(mels, motion, draws)
        w = batch.get("weight")
        rw = w[:, None, None] if w is not None \
            else torch.ones(mels.shape[0], 1, 1, device=mels.device)
        vel_r = recon[:, 1:] - recon[:, :-1]
        vel_g = motion[:, 1:] - motion[:, :-1]
        # the global batch's sums (every rank's rows)
        rec, kl, vel, rows = global_sums(
            ((recon - motion).abs() * rw).sum(),
            (kl_gauss(mu_q, lv_q, mu_p, lv_p) * rw).sum(),
            ((vel_r - vel_g).abs() * rw).sum(), rw.sum())
        denom = (rows * motion.shape[1]).clamp_min(1.0)
        l_rec = rec / (denom * motion.shape[-1])
        l_kl = kl / (denom * mu_q.shape[-1])
        l_vel = vel / (denom * motion.shape[-1])
        total = l_rec + cfg.lambda_kl * l_kl + cfg.lambda_vel * l_vel
        return total, {"recon_loss": l_rec.detach(),
                       "kl_loss": l_kl.detach(),
                       "vel_loss": l_vel.detach(),
                       "total_loss": total.detach()}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        return {"model": self.loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"model": self.cfg.optim}
