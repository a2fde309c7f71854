"""Audio-captioning training: teacher-forced, label-smoothed
cross-entropy.

Counterpart of ``audiogpt_tpu/train/tasks/caption.py`` (the A2T captioner
trains in its own repo, ``audio_to_text/captioning/``; AudioGPT ships
inference only). The captioner (``models/caption/captioner.py``: Cnn14,
the bidirectional GRU with JAX's padded-row reversal, the transformer
decoder) reads ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``; the CE
is masked by ``token_len − 1`` and ``weight``. JAX applies the model with
``train=False``, so Cnn14's BatchNorms use their running statistics:
:class:`CaptionTask` keeps Cnn14 in eval mode whatever mode the model is
put in, and a step moves no buffer. The model is built in training mode
(it has no dropout): cuDNN's GRU takes a backward only in that mode. The
loss draws nothing.

Batch schema: ``wav`` [B, T], ``wav_len`` [B], ``tokens`` [B, L] with the
<sos> prefix and <eos> end, ``token_len`` [B], ``weight`` [B]
(``collate_audio_text`` with ``schema="caption"``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.caption.captioner import (CaptionConfig,
                                                         CaptionModel)
from audiogpt_tpu_torch.parallel.reduce import global_sums
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


class _RunningStatsCaptioner(CaptionModel):
    """The captioner whose Cnn14 stays in eval mode (JAX's
    ``train=False``: its BatchNorms on their running statistics). The rest
    takes the mode it is given; it has no dropout, so the mode changes
    nothing there but cuDNN's GRU, whose backward runs only in training
    mode."""

    def train(self, mode: bool = True) -> "_RunningStatsCaptioner":
        super().train(mode)
        self.cnn.eval()
        return self


@dataclasses.dataclass(frozen=True)
class CaptionTaskConfig:
    model: CaptionConfig = CaptionConfig()
    label_smoothing: float = 0.1
    optim: OptimConfig = OptimConfig(
        optimizer="adam", lr=5e-4, schedule="rsqrt", warmup_steps=5000,
        hidden_size=256, clip_grad_norm=1.0)


class CaptionTask:
    """One optimized group, ``model``. ``params``: the JAX task's
    ``{"model": {"params", "batch_stats"}}`` tree (numpy leaves) to load;
    ``None`` keeps a seeded random init. ``device=None`` is the card, and
    raises without one."""

    def __init__(self, cfg: CaptionTaskConfig, params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: _RunningStatsCaptioner(
            cfg.model)).to(self.device).train()
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        load_jax_params(self.model, params["model"])

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None):
        """→ (ce, {ce, token_acc, total_loss})."""
        tokens = batch["tokens"].long()
        wav_len = batch.get("wav_len")
        logits = self.model(batch["wav"], tokens[:, :-1],
                            None if wav_len is None else wav_len.long())
        target = tokens[:, 1:]
        v = logits.shape[-1]
        logp = torch.log_softmax(logits, dim=-1)
        smooth = self.cfg.label_smoothing
        onehot = F.one_hot(target, v).to(logp.dtype) * (1 - smooth) \
            + smooth / v
        nll = -(onehot * logp).sum(-1)                       # [B, L-1]
        mask = (torch.arange(target.shape[1], device=target.device)[None]
                < (batch["token_len"].long()[:, None] - 1)).to(logp.dtype)
        w = batch.get("weight")
        if w is not None:
            mask = mask * w[:, None]
        nll_sum, hits, count = global_sums(
            (nll * mask).sum(), ((logits.argmax(-1) == target) * mask).sum(),
            mask.sum())
        denom = count.clamp_min(1.0)
        loss = nll_sum / denom
        acc = hits / denom
        return loss, {"ce": loss.detach(), "token_acc": acc.detach(),
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
