"""PortaSpeech / SyntaSpeech training task.

Counterpart of ``audiogpt_tpu/train/tasks/portaspeech.py`` (the
reference's ``PortaSpeechTask``, ``NeuralSeq/tasks/tts/ps.py``): mel L1 +
SSIM, the KL with a floor and a linear ramp over ``kl_start_steps``
(ps.py:55-59), the word-level duration L1 in the log(1 + d) domain plus
the optional sentence-duration L1 (``add_dur_loss``, ps.py:86-101). The
SyntaSpeech task (``tasks/tts/synta.py``) is the same recipe over the
graph-augmented model (``model.use_graph``).

The model runs its training branch (``PortaSpeech.train_forward``) on the
ground-truth ``mel2word`` and mel; its one draw, the posterior's ε, comes
from the trainer's generator (for the global batch, cut to a rank's rows)
or is replayed (``draws=``). Every mean runs over the global batch. The KL
ramp
reads ``batch["step"]``, which the trainer sets; without it the ramp is
1. With ``model.num_spk > 0`` the batch's ``spk_ids`` pick the speaker
style. The module is grouped as ``{"model": PortaSpeech}`` with the posterior
encoder, the JAX task's tree. The phone and word ids must be below
``model.ph_vocab_size`` and ``model.word_vocab_size``: on the card an id
past an embedding is a device-side assert (JAX's gather clamps it), so
``train_cli.build_loaders`` checks the binarized sets against them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.tts.portaspeech import (PortaSpeech,
                                                       PortaSpeechConfig,
                                                       mel2word_to_dur)
from audiogpt_tpu_torch.parallel.reduce import global_rows, local_rows
from audiogpt_tpu_torch.train import losses as L
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.train.ssim import ssim_loss
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


@dataclasses.dataclass(frozen=True)
class PortaSpeechTaskConfig:
    model: PortaSpeechConfig = PortaSpeechConfig()
    lambda_mel: float = 1.0
    lambda_ssim: float = 1.0
    lambda_kl: float = 1.0          # ps.yaml lambda_kl
    kl_min: float = 0.0             # ps.yaml kl_min
    kl_start_steps: int = 10000     # ps.yaml kl_start_steps
    lambda_word_dur: float = 1.0    # fs2.yaml lambda_word_dur
    lambda_sent_dur: float = 0.0    # ps.yaml lambda_sent_dur
    optim: OptimConfig = OptimConfig()


class PortaSpeechTask:
    """One optimized group, ``model``. ``params``: the JAX task's tree
    (numpy leaves) to load; ``None`` keeps a seeded random init.
    ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: PortaSpeechTaskConfig,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: PortaSpeech(
            cfg.model, posterior=True)).to(self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"model": ...}`` tree (numpy leaves, with
        ``fvae_enc``), strictly."""
        load_jax_params(self.model, params["model"])

    def draws(self, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator | None) -> torch.Tensor:
        """The posterior's ε [B, ⌈F/s⌉, latent] for ``batch``'s mels."""
        b, f = batch["mels"].shape[:2]
        return local_rows(torch.randn(
            self.model.eps_shape(global_rows(b), f), generator=generator,
            device=batch["mels"].device))

    def _word_dur_loss(self, dur_pred, mel2word, word_tokens, weight):
        """log(1 + d) L1 over the words, and the sentence totals' L1 with
        ``lambda_sent_dur`` (ps.py:86)."""
        cfg = self.cfg
        dur_gt = mel2word_to_dur(mel2word, word_tokens.shape[1])
        nonpad = (word_tokens > 0).float()
        if weight is not None:
            nonpad = nonpad * weight[:, None]
        wdur = (torch.log1p(dur_pred) - torch.log1p(dur_gt)).abs()
        out = {"wdur": L.masked_mean(wdur, nonpad) * cfg.lambda_word_dur}
        if cfg.lambda_sent_dur > 0:
            sent_p = (dur_pred * nonpad).sum(-1)
            sent_g = (dur_gt * nonpad).sum(-1)
            rw = weight if weight is not None else torch.ones_like(sent_p)
            out["sdur"] = L.weighted_mean((sent_p - sent_g).abs(), rw) \
                * cfg.lambda_sent_dur
        return out

    def kl_ramp(self, batch: Mapping) -> float:
        """min(step / kl_start_steps, 1) in f32, as JAX's; 1 without a
        step."""
        cfg = self.cfg
        step = batch.get("step", cfg.kl_start_steps)
        step = np.float32(step.item() if torch.is_tensor(step) else step)
        return float(np.clip(step / np.float32(max(cfg.kl_start_steps, 1)),
                             0.0, 1.0))

    def forward_and_losses(self, batch: Mapping[str, torch.Tensor],
                           draws: torch.Tensor | torch.Generator | None):
        """→ (total, metrics, model outputs); the metrics are not detached
        (the adversarial recipe adds to them)."""
        cfg = self.cfg
        mel2word = batch.get("mel2word")
        if mel2word is None:
            # no word alignment in the corpus → uniform frames a word
            mel2word = L.uniform_mel2ph(batch["word_lengths"],
                                        batch["mel_lengths"],
                                        batch["mels"].shape[1])
        spk = batch.get("spk_ids") if cfg.model.num_spk > 0 else None
        out = self.model.train_forward(
            batch["txt_tokens"].long(), batch["word_tokens"].long(),
            batch["ph2word"].long(), mel2word.long(), batch["mels"],
            graph_adj=batch.get("graph_adj"), draws=draws,
            spk_id=None if spk is None else spk.long())
        w = batch.get("weight")
        target = batch["mels"]
        mel_mask = L.weights_nonzero_speech(target)
        if w is not None:
            mel_mask = mel_mask * w[:, None]
        metrics = {"mel": L.mel_l1_loss(out["mel_out"], target, w)
                   * cfg.lambda_mel}
        if cfg.lambda_ssim > 0:
            metrics["ssim"] = ssim_loss(out["mel_out"], target, mel_mask) \
                * cfg.lambda_ssim
        # the KL: a floor and a linear warm-up over kl_start_steps
        metrics["kl_v"] = out["kl"]
        metrics["kl"] = out["kl"].clamp_min(cfg.kl_min) \
            * self.kl_ramp(batch) * cfg.lambda_kl
        metrics.update(self._word_dur_loss(out["dur"], mel2word.long(),
                                           batch["word_tokens"], w))
        total = sum(v for k, v in metrics.items() if k != "kl_v")
        metrics["total_loss"] = total
        return total, metrics, out

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None,
             draws: torch.Tensor | None = None):
        """→ (total, metrics): ``mel``, ``ssim``, ``kl_v`` (the raw KL,
        not in the total), ``kl``, ``wdur``, ``sdur`` with
        ``lambda_sent_dur``, ``total_loss``. ``draws`` (ε) replaces the
        draw from ``generator``."""
        if draws is None:
            draws = self.draws(batch, generator)
        total, metrics, _ = self.forward_and_losses(batch, draws)
        return total, {k: v.detach() for k, v in metrics.items()}

    def visualize(self, batch: Mapping[str, torch.Tensor],
                  generator: torch.Generator | None = None) -> dict:
        """The first item's predicted and ground-truth mel over its valid
        frames, ``{"mel_0": (pred, gt)}`` (``save_valid_result``)."""
        _, _, out = self.forward_and_losses(batch,
                                            self.draws(batch, generator))
        if "mel_lengths" in batch:
            n = int(batch["mel_lengths"][0])
        else:
            n = int((batch["mels"][0].abs().sum(-1) > 0).sum())
        n = max(n, 1)
        return {"mel_0": (out["mel_out"][0, :n], batch["mels"][0, :n])}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        return {"model": self.loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"model": self.cfg.optim}
