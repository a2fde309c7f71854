"""Continuous-wavelet f0 recomposition: FastSpeech2's ``pitch_type="cwt"``.

Counterpart of ``inverse_cwt`` and ``cwt2f0`` in
``audiogpt_tpu/dsp/f0.py:171-192`` (the reference's ``utils/cwt.py``), in
torch: the predicted 10-scale Mexican-hat spectrum of the log-f0 is summed
with fixed weights, re-standardised over the frames and mapped back to Hz
by the predicted per-utterance mean and std. The forward transform
(``cwt_lf0``, Mexican hat) builds training targets and is not ported yet.
"""

from __future__ import annotations

import torch


def inverse_cwt(w: torch.Tensor) -> torch.Tensor:
    """[B, T, S] scales → [B, T]: the sum over scales with weights
    ``(i + 1 + 2.5)^-2.5``, standardised over T (population std, floored
    at 1e-8)."""
    b = (torch.arange(w.shape[-1], dtype=w.dtype, device=w.device)
         + 1.0 + 2.5) ** (-2.5)
    rec = (w * b).sum(-1)
    mean = rec.mean(-1, keepdim=True)
    std = rec.std(-1, correction=0, keepdim=True)
    return (rec - mean) / std.clamp_min(1e-8)


def cwt2f0(cwt_spec: torch.Tensor, mean: torch.Tensor,
           std: torch.Tensor) -> torch.Tensor:
    """[B, T, 10] CWT + per-utterance log-f0 mean and std [B] → f0 Hz
    [B, T]."""
    lf0 = inverse_cwt(cwt_spec) * std[:, None] + mean[:, None]
    return torch.exp(lf0)
