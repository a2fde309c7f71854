"""Speech separation and enhancement training: SI-SNR with permutation
invariance.

Counterpart of ``audiogpt_tpu/train/tasks/separation.py`` (the ESPnet
Conv-TasNet recipes behind the reference's Speech_Enh / Speech_SS tools
train with negative SI-SNR and utterance-level PIT). The loss is the
weighted mean of −SI-SNR under the best permutation of the sources, the
permutations enumerated statically; ``n_src`` 1 is plain SI-SNR
(enhancement). The loss draws nothing.

Batch schema: ``mix`` [B, T], ``sources`` [B, n_src, T], ``weight`` [B]
(``data/loader.py`` ``collate_mixture``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.separation.convtasnet import (
    ConvTasNet, ConvTasNetConfig)
from audiogpt_tpu_torch.parallel.reduce import global_mean, global_sums
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


def si_snr(est: torch.Tensor, ref: torch.Tensor,
           eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB over the last axis (eps in the projection's
    denominator, the noise energy and the log, as JAX places them)."""
    est = est - est.mean(-1, keepdim=True)
    ref = ref - ref.mean(-1, keepdim=True)
    proj = ((est * ref).sum(-1, keepdim=True)
            / ((ref * ref).sum(-1, keepdim=True) + eps)) * ref
    noise = est - proj
    ratio = (proj * proj).sum(-1) / ((noise * noise).sum(-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def pit_si_snr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """est/ref [B, n_src, T] → the best permutation's mean SI-SNR [B]."""
    n = est.shape[1]
    scores = [si_snr(est[:, list(perm)], ref).mean(-1)
              for perm in itertools.permutations(range(n))]
    return torch.stack(scores, -1).amax(-1)


@dataclasses.dataclass(frozen=True)
class SeparationTaskConfig:
    model: ConvTasNetConfig = ConvTasNetConfig()
    optim: OptimConfig = OptimConfig(
        optimizer="adam", lr=1e-3, schedule="constant", clip_grad_norm=5.0)


class SeparationTask:
    """One optimized group, ``model``. ``params``: the JAX task's
    ``{"model": {"params": ...}}`` tree (numpy leaves) to load; ``None``
    keeps a seeded random init. ``device=None`` is the card, and raises
    without one."""

    def __init__(self, cfg: SeparationTaskConfig,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: ConvTasNet(cfg.model)).to(
            self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        load_jax_params(self.model, params["model"])

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None):
        """→ (−SI-SNR, {neg_si_snr, total_loss})."""
        est = self.model(batch["mix"])                   # [B, n_src, T]
        snr = pit_si_snr(est, batch["sources"])          # [B]
        w = batch.get("weight")
        if w is not None:
            num, den = global_sums((snr * w).sum(), w.sum())
            loss = -num / den.clamp_min(1.0)
        else:
            loss = -global_mean(snr)
        return loss, {"neg_si_snr": loss.detach(),
                      "total_loss": loss.detach()}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        return {"model": self.loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"model": self.cfg.optim}
