"""Pitch-extractor training task.

Counterpart of ``audiogpt_tpu/train/tasks/pe.py`` (the reference's
``NeuralSeq/tasks/tts/pe.py``): the f0 L1 on voiced frames and the uv
BCE of ``models/tts/pitch_extractor.py``'s prediction from the
ground-truth mel, over the frames whose mel is not all zero. Batch schema:
``{"mels", "f0", "uv", "weight"}`` (``collate_tts``). A batch without
``uv`` (``TTSBinarizer`` writes none) takes uv = (f0 == 0), as the FS2
and GenerSpeech recipes do; JAX's task reads ``batch["uv"]`` and raises
without it.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.tts.fastspeech2 import norm_f0
from audiogpt_tpu_torch.models.tts.pitch_extractor import (
    PitchExtractor, PitchExtractorConfig)
from audiogpt_tpu_torch.train import losses as L
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


@dataclasses.dataclass(frozen=True)
class PETaskConfig:
    model: PitchExtractorConfig = PitchExtractorConfig()
    lambda_f0: float = 1.0
    lambda_uv: float = 1.0
    optim: OptimConfig = OptimConfig()


class PETask:
    """One optimized group, ``model``. ``params``: the JAX task's tree
    (numpy leaves) to load; ``None`` keeps a seeded random init.
    ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: PETaskConfig, params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: PitchExtractor(cfg.model)).to(
            self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        load_jax_params(self.model, params["model"])

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None):
        """→ (total, {f0, uv, total_loss}). The loss draws nothing:
        ``generator`` is the trainer's protocol."""
        cfg = self.cfg
        mels = batch["mels"]
        out = self.model(mels)
        f0 = batch["f0"]
        uv = batch.get("uv")
        if uv is None:
            uv = (f0 == 0).to(f0.dtype)
        f0n = norm_f0(f0, uv, cfg.model._fs2_like)
        nonpad = (mels.abs().sum(-1) > 0).long()
        metrics = L.f0_loss(out["pitch_pred"], f0n, uv, nonpad,
                            batch.get("weight"), lambda_f0=cfg.lambda_f0,
                            lambda_uv=cfg.lambda_uv, use_uv=cfg.model.use_uv)
        total = sum(metrics.values())
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return total, metrics

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        return {"model": self.loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"model": self.cfg.optim}
