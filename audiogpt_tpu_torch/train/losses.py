"""Masked loss helpers of the TTS recipes.

Counterpart of ``audiogpt_tpu/train/losses.py`` (the reference's
``NeuralSeq/tasks/tts/fs2.py:140-286``: mel L1 / SSIM with nonzero-speech
weights, log-domain duration MSE, f0 L1 + uv BCE, energy MSE). Every loss
takes explicit masks: the static-shape batches carry padded frames AND
whole dummy rows (``batch['weight']``), and both must zero out. Every
reduction over the batch's rows sums its numerator and its count over the
data-parallel ranks (``parallel/reduce.py``), so each rank gets the loss of
the global batch, as JAX's step on the sharded batch does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audiogpt_tpu_torch.parallel.reduce import global_mean, global_sums


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Σ x·mask / Σ mask over the global batch."""
    num, den = global_sums((x * mask).sum(), mask.sum())
    return num / den.clamp_min(1.0)


def weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ x·w / Σ w over the global batch, ``w`` broadcast over ``x``'s
    trailing axes per row ([B] weights of [B] values: a row mean)."""
    num, den = global_sums((x * w).sum(), w.sum())
    return num / den.clamp_min(1.0)


def weights_nonzero_speech(target: torch.Tensor) -> torch.Tensor:
    """[B, T, M] mel → [B, T] 1.0 where the frame isn't all-zero padding
    (fs2.py ``weights_nonzero_speech``)."""
    return (target.abs().sum(-1) > 0).float()


def mel_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                row_weight: torch.Tensor | None = None) -> torch.Tensor:
    w = weights_nonzero_speech(target)
    if row_weight is not None:
        w = w * row_weight[:, None]
    num, den = global_sums(((pred - target).abs() * w[..., None]).sum(),
                           w.sum())
    return num / (den * target.shape[-1]).clamp_min(1.0)


def uniform_mel2ph(txt_lengths: torch.Tensor, mel_lengths: torch.Tensor,
                   n_frames: int) -> torch.Tensor:
    """Uniform frame→phone alignment for corpora without forced alignment
    (the reference requires MFA TextGrids, ``base_binarizer.py:188``; this
    fallback spreads each item's frames evenly over its tokens so the
    duration and pitch losses stay defined) → [B, n_frames] long."""
    f_idx = torch.arange(n_frames, device=txt_lengths.device)[None, :]
    valid = f_idx < mel_lengths[:, None]
    ph = torch.floor(f_idx * txt_lengths[:, None].float()
                     / mel_lengths[:, None].clamp_min(1).float()) + 1
    ph = torch.minimum(ph.clamp_min(1),
                       txt_lengths[:, None].clamp_min(1).float())
    return torch.where(valid, ph, 0.0).long()


def mel2ph_to_dur(mel2ph: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """[B, F] frame→phone map → [B, T] per-phone frame counts
    (``modules/fastspeech/tts_modules.py`` mel2ph_to_dur)."""
    counts = torch.zeros(mel2ph.shape[0], n_tokens + 1,
                         device=mel2ph.device)
    counts.scatter_add_(1, mel2ph.long(), torch.ones_like(counts[:, :1])
                        .expand_as(mel2ph))
    return counts[:, 1:]


def dur_loss(dur_pred_log: torch.Tensor, mel2ph: torch.Tensor,
             txt_tokens: torch.Tensor,
             row_weight: torch.Tensor | None = None,
             lambda_ph: float = 0.1, lambda_sent: float = 1.0) -> dict:
    """Log-domain phone-duration MSE + sentence-duration MSE
    (fs2.py:175-218, 'mse' branch)."""
    nonpad = (txt_tokens > 0).float()
    if row_weight is not None:
        nonpad = nonpad * row_weight[:, None]
    dur_gt = mel2ph_to_dur(mel2ph, txt_tokens.shape[1]) * nonpad
    pdur = masked_mean((dur_pred_log - torch.log(dur_gt + 1.0)) ** 2, nonpad)
    losses = {"pdur": pdur * lambda_ph}
    if lambda_sent > 0:
        sent_p = (torch.exp(dur_pred_log) - 1.0).clamp_min(0) * nonpad
        sdur = (torch.log(sent_p.sum(-1) + 1.0)
                - torch.log(dur_gt.sum(-1) + 1.0)) ** 2
        sdur = weighted_mean(sdur, row_weight) if row_weight is not None \
            else global_mean(sdur)
        losses["sdur"] = sdur * lambda_sent
    return losses


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise ``max(x, 0) − x·z + log1p(exp(−|x|))``, JAX's form."""
    return F.relu(logits) - logits * target \
        + torch.log1p(torch.exp(-logits.abs()))


def f0_loss(pitch_pred: torch.Tensor, f0_norm: torch.Tensor,
            uv: torch.Tensor, mel2ph: torch.Tensor,
            row_weight: torch.Tensor | None = None, lambda_f0: float = 1.0,
            lambda_uv: float = 1.0, use_uv: bool = True) -> dict:
    """f0 L1 on voiced frames + uv logit BCE (fs2.py:254-269)."""
    nonpad = (mel2ph > 0).float()
    if row_weight is not None:
        nonpad = nonpad * row_weight[:, None]
    losses = {}
    if use_uv:
        losses["uv"] = masked_mean(bce_with_logits(pitch_pred[..., 1], uv),
                                   nonpad) * lambda_uv
        nonpad = nonpad * (uv == 0).float()
    losses["f0"] = masked_mean((pitch_pred[..., 0] - f0_norm).abs(),
                               nonpad) * lambda_f0
    return losses


def energy_loss(energy_pred: torch.Tensor, energy: torch.Tensor,
                lambda_energy: float = 0.1) -> torch.Tensor:
    nonpad = (energy != 0).float()
    return masked_mean((energy_pred - energy) ** 2, nonpad) * lambda_energy
