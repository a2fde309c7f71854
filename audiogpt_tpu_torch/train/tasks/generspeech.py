"""GenerSpeech training task.

Counterpart of ``audiogpt_tpu/train/tasks/generspeech.py`` (the
reference's GenerSpeech recipe under ``NeuralSeq/tasks/tts/``): the
FastSpeech2 reconstruction losses (mel L1 + SSIM, log-domain durations,
f0 L1 + uv BCE), the VQ commitment with the codebook loss, the aligners'
guided-attention loss and the Glow post-flow's NLL of the target mel
(``run_post_glow``). The target mel is also the style reference (the
self-reconstruction setup). As in JAX, the model is built with
``vq_ema=False``: the codebooks are parameters that the codebook loss
trains, so the step updates no state besides the optimizer's.

The model's one random step is ``MixStyle``'s (a permutation, a Beta λ
per item, one Bernoulli for the batch), drawn from the trainer's
generator or replayed (``draws=``). Batch schema: ``collate_tts``'s, from
records of ``data/binarizer.py`` ``EmotionBinarizer`` (or
``TTSBinarizer``); the batch's ``emo_ids`` are not read, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.tts.fastspeech2 import norm_f0
from audiogpt_tpu_torch.models.tts.generspeech import (GenerSpeech,
                                                       GenerSpeechConfig)
from audiogpt_tpu_torch.train import losses as L
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.train.ssim import ssim_loss
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


@dataclasses.dataclass(frozen=True)
class GenerSpeechTaskConfig:
    model: GenerSpeechConfig = GenerSpeechConfig()
    lambda_mel: float = 1.0
    lambda_ssim: float = 1.0
    lambda_ph_dur: float = 0.1
    lambda_sent_dur: float = 1.0
    lambda_f0: float = 1.0
    lambda_uv: float = 1.0
    lambda_commit: float = 0.25     # VQ commitment (prosody_util.py:16)
    lambda_guided: float = 1.0
    lambda_postflow: float = 1.0
    optim: OptimConfig = OptimConfig()


class GenerSpeechTask:
    """One optimized group, ``model``. ``params``: the JAX task's tree
    (numpy leaves, ``vq_ema=False``) to load; ``None`` keeps a seeded
    random init. ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: GenerSpeechTaskConfig,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        if cfg.model.vq_ema:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, vq_ema=False))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: GenerSpeech(cfg.model)).to(
            self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"model": {"params": ...}}`` tree, strictly."""
        load_jax_params(self.model, params["model"])

    def draws(self, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator | None) -> dict:
        """``MixStyle``'s draws for the batch (``MixStyle.draws``)."""
        tokens = batch["txt_tokens"]
        return self.model.mixstyle.draws(tokens.shape[0], generator,
                                         tokens.device)

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None,
             draws: dict | None = None):
        """→ (total, metrics): ``mel``, ``commit``, ``guided``, ``ssim``,
        ``postflow``, ``pdur``, ``sdur``, with f0 ``f0`` and ``uv``, and
        ``total_loss``. ``draws`` replaces ``MixStyle``'s draws from
        ``generator``."""
        cfg = self.cfg
        mcfg = cfg.model.fs2
        if draws is None:
            draws = self.draws(batch, generator)
        f0 = batch.get("f0")
        uv = batch.get("uv")
        if uv is None and f0 is not None:
            uv = (f0 == 0).to(f0.dtype)
        f0n = norm_f0(f0, uv, mcfg) if f0 is not None else None
        mel2ph = batch.get("mel2ph")
        if mel2ph is None:
            # unaligned corpus → uniform fallback (FS2Task's policy)
            mel2ph = L.uniform_mel2ph(batch["txt_lengths"],
                                      batch["mel_lengths"],
                                      batch["mels"].shape[1])
        mel2ph = mel2ph.long()
        tokens = batch["txt_tokens"].long()
        out = self.model(tokens, batch["mels"], mel2ph=mel2ph, f0=f0n,
                         uv=uv, draws=draws, train=True)
        w = batch.get("weight")
        target = batch["mels"]
        mel_mask = L.weights_nonzero_speech(target)
        if w is not None:
            mel_mask = mel_mask * w[:, None]
        metrics = {
            "mel": L.mel_l1_loss(out["mel_out"], target, w) * cfg.lambda_mel,
            "commit": out["vq_commit"] * cfg.lambda_commit,
            "guided": out["guided_attn"] * cfg.lambda_guided}
        if cfg.lambda_ssim > 0:
            metrics["ssim"] = ssim_loss(out["mel_out"], target, mel_mask) \
                * cfg.lambda_ssim
        if "postflow_nll" in out:
            metrics["postflow"] = out["postflow_nll"] * cfg.lambda_postflow
        metrics.update(L.dur_loss(
            out["dur"], mel2ph, tokens, w, lambda_ph=cfg.lambda_ph_dur,
            lambda_sent=cfg.lambda_sent_dur))
        if f0n is not None:
            metrics.update(L.f0_loss(
                out["pitch_pred"], f0n, uv, mel2ph, w,
                lambda_f0=cfg.lambda_f0, lambda_uv=cfg.lambda_uv,
                use_uv=mcfg.use_uv))
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
