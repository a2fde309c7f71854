"""CLAP contrastive pretraining (audio ↔ text).

Counterpart of ``audiogpt_tpu/train/tasks/clap.py`` (the reference vendors
open_clap's training stack: the CLAP model, ``open_clap/model.py:422``, and
``loss.py``'s ``ClipLoss`` with a learned temperature): both towers and the
learned ``logit_scale`` in one module, the symmetric InfoNCE over the
batch's audio × text similarities. Padded rows (``weight`` 0) leave both
the softmax (their columns get −1e9) and the average (their rows weigh 0);
the accuracy reads the same column mask. ``logit_scale`` starts at
log(1 / 0.07) and is clipped to [−10, log 100] before its ``exp``, so past
the clip its gradient is 0.

The audio tower is Cnn14 (``models/caption/cnn14.py``) through its
projection; JAX runs it with ``train=False``, so its BatchNorms use their
running statistics while the gradients flow. :class:`CLAPModel` keeps the
tower in eval mode whatever mode it is put in, so a step neither reads the
batch's statistics nor moves the buffers. The text tower is the BERT CLS
projection of the ranking path's ``CLAPScorer``; its dense key mask keeps
it on the plain attention. The loss draws nothing. In a data-parallel
run the logits are the global batch's B×B: each rank gathers every rank's
embeddings and weights (``gather_rows``), as JAX's step scores the whole
sharded batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config
from audiogpt_tpu_torch.models.textenc.clap import (CLAPAudioEncoder,
                                                    CLAPTextConfig,
                                                    CLAPTextEncoder)
from audiogpt_tpu_torch.parallel.reduce import gather_rows
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

#: the clip of ``logit_scale`` before its exp (open_clap: a scale ≤ 100)
SCALE_CLIP = (-10.0, math.log(100.0))


class CLAPModel(nn.Module):
    """Both towers (``text``, ``audio``, the JAX tree's scope names) and
    the learned temperature: ``forward(wav, tokens, attention_mask,
    wav_len)`` → (audio embeddings, text embeddings, each L2-normalised
    [B, d_proj], and the clipped scale's exp)."""

    def __init__(self, text_cfg: CLAPTextConfig, d_proj: int = 1024,
                 audio_cfg: Cnn14Config | None = None):
        super().__init__()
        self.text = CLAPTextEncoder(text_cfg)
        self.audio = CLAPAudioEncoder(d_proj, cnn14=audio_cfg)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        self.audio.eval()

    def train(self, mode: bool = True) -> "CLAPModel":
        super().train(mode)
        # Cnn14's BatchNorms keep their running statistics (JAX's
        # train=False)
        self.audio.eval()
        return self

    def forward(self, wav: torch.Tensor, tokens: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                wav_len: torch.Tensor | None = None):
        a = self.audio(wav, wav_len)
        t = self.text.cls_embedding(tokens, attention_mask)
        a = a / torch.linalg.vector_norm(a, dim=-1,
                                         keepdim=True).clamp_min(1e-8)
        t = t / torch.linalg.vector_norm(t, dim=-1,
                                         keepdim=True).clamp_min(1e-8)
        return a, t, torch.exp(self.logit_scale.clamp(*SCALE_CLIP))


def masked_infonce(logits: torch.Tensor, weight: torch.Tensor
                   ) -> torch.Tensor:
    """Cross-entropy along axis 1 with the invalid columns masked out
    (−1e9) and the invalid rows weighted 0; the diagonal is the positive
    pair."""
    neg = torch.where(weight[None, :] > 0, 0.0, -1e9)
    logp = torch.log_softmax(logits + neg, dim=1)
    return -(torch.diagonal(logp) * weight).sum() / weight.sum().clamp_min(1.0)


@dataclasses.dataclass(frozen=True)
class CLAPTaskConfig:
    text: CLAPTextConfig = CLAPTextConfig()
    d_proj: int = 1024
    #: the audio tower's Cnn14Config (None: the PANN checkpoint's layout)
    audio: Cnn14Config | None = None
    optim: OptimConfig = OptimConfig(
        optimizer="adamw", lr=1e-4, schedule="constant", beta2=0.98,
        weight_decay=0.0)


class CLAPTask:
    """One optimized group, ``model``. ``params``: the JAX task's
    ``{"model": {"params": {text, audio, logit_scale}, "batch_stats"}}``
    tree (numpy leaves) to load; ``None`` keeps a seeded random init.
    ``device=None`` is the card, and raises without one.

    Batch schema: ``wav`` [B, T] (the tower's frontend resamples nothing:
    Cnn14's 32 kHz mel runs on it as it is, as in JAX), ``text_ids``
    [B, L], ``text_mask`` [B, L], ``wav_len`` [B], ``weight`` [B]
    (``collate_audio_text`` with ``schema="clap"``)."""

    def __init__(self, cfg: CLAPTaskConfig, params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: CLAPModel(
            cfg.text, cfg.d_proj, cfg.audio)).to(self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"model": ...}`` tree (with Cnn14's
        ``batch_stats``), strictly."""
        load_jax_params(self.model, params["model"])

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None):
        """→ (loss, {total_loss, nce_a, nce_t, scale, acc})."""
        mask = batch.get("text_mask")
        wav_len = batch.get("wav_len")
        a, t, scale = self.model(batch["wav"], batch["text_ids"].long(),
                                 None if mask is None else mask.long(),
                                 None if wav_len is None else wav_len.long())
        w = batch.get("weight")
        if w is None:
            w = torch.ones(a.shape[0], dtype=a.dtype, device=a.device)
        # the global batch's B×B logits: every rank's embeddings
        a, t, w = gather_rows(a), gather_rows(t), gather_rows(w)
        logits_at = scale * (a @ t.T)
        loss_a = masked_infonce(logits_at, w)
        loss_t = masked_infonce(logits_at.T, w)
        loss = 0.5 * (loss_a + loss_t)
        neg = torch.where(w[None, :] > 0, 0.0, -1e9)
        hit = ((logits_at + neg).argmax(1) == torch.arange(
            a.shape[0], device=a.device)).float()
        metrics = {"total_loss": loss.detach(), "nce_a": loss_a.detach(),
                   "nce_t": loss_t.detach(), "scale": scale.detach(),
                   "acc": (hit * w).sum() / w.sum().clamp_min(1.0)}
        return loss, metrics

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        return {"model": self.loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"model": self.cfg.optim}
