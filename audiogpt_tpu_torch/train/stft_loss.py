"""Multi-resolution STFT loss for vocoder training.

Counterpart of ``audiogpt_tpu/train/stft_loss.py`` (the reference's
``NeuralSeq/modules/parallel_wavegan/losses/stft_loss.py``): per
resolution, the spectral convergence ‖|S_r| − |S_f|‖_F / ‖|S_r|‖_F (the
Frobenius norm over the whole batch) plus the log-magnitude L1, each
averaged over the resolutions (1024/120/600, 2048/240/1200, 512/50/240),
on the port's ``dsp/stft.py`` (centred frames, the Hann window of
``win_length`` centred and zero-padded to ``n_fft``). The magnitude is
clipped at 1e-7 in power before its root and the log. Both run over the
global batch of a data-parallel run (``parallel/reduce.py``).
"""

from __future__ import annotations

import torch

from audiogpt_tpu_torch.dsp.stft import stft
from audiogpt_tpu_torch.parallel.reduce import global_l2, global_mean

RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def _magnitude(x: torch.Tensor, n_fft: int, hop: int,
               win: int) -> torch.Tensor:
    s = stft(x, n_fft, hop, win_length=win)
    return torch.sqrt((s.real ** 2 + s.imag ** 2).clamp_min(1e-7))


def stft_loss(fake: torch.Tensor, real: torch.Tensor,
              resolutions=RESOLUTIONS) -> tuple[torch.Tensor, torch.Tensor]:
    """(spectral_convergence, log_magnitude) losses, each averaged over
    the resolutions. Inputs [B, T]."""
    sc, mag = 0.0, 0.0
    for n_fft, hop, win in resolutions:
        mf = _magnitude(fake, n_fft, hop, win)
        mr = _magnitude(real, n_fft, hop, win)
        sc = sc + global_l2(mr - mf) / global_l2(mr).clamp_min(1e-7)
        mag = mag + global_mean((torch.log(mr) - torch.log(mf)).abs())
    n = len(resolutions)
    return sc / n, mag / n
