"""SSIM on mel 'images' — FastSpeech2's auxiliary reconstruction loss.

Counterpart of ``audiogpt_tpu/train/ssim.py`` (the reference's
``NeuralSeq/modules/commons/ssim.py``, window 11, sigma 1.5, inputs
shifted by +6 in ``tasks/tts/fs2.py:164-173``). The Gaussian blur is two
cross-correlations with a [11, 1] and a [1, 11] window and zero padding of
5 on the blurred axis, ``F.conv2d`` as JAX's ``lax.conv_general_dilated``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from audiogpt_tpu_torch.parallel.reduce import global_sums


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian filter over the last two axes of [B, H, W]."""
    k = win.shape[0]
    pad = k // 2
    x = F.conv2d(img[:, None], win.reshape(1, 1, k, 1), padding=(pad, 0))
    return F.conv2d(x, win.reshape(1, 1, 1, k), padding=(0, pad))[:, 0]


def ssim(x: torch.Tensor, y: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Per-pixel SSIM map for [B, H, W] images (no averaging: callers weight
    by the padding mask, as the reference's ``size_average=False`` path
    does)."""
    win = torch.from_numpy(_gaussian_window(window_size, sigma)).to(
        x.device, x.dtype, non_blocking=True)
    mu_x, mu_y = _blur(x, win), _blur(y, win)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = _blur(x * x, win) - mu_x2
    sig_y = _blur(y * y, win) - mu_y2
    sig_xy = _blur(x * y, win) - mu_xy
    return ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / \
        ((mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2))


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              bias: float = 6.0) -> torch.Tensor:
    """1 − SSIM, masked mean over the global batch:
    ``FastSpeech2Task.ssim_loss`` (``fs2.py:164-173``). pred/target [B, T,
    M], mask [B, T]."""
    s = ssim(pred + bias, target + bias)
    w = mask[..., None]
    num, den = global_sums(((1.0 - s) * w).sum(), w.sum())
    return num / (den * pred.shape[-1]).clamp_min(1.0)
