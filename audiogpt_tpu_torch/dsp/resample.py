"""Sample-rate conversion: rational L/M resampling with a Kaiser-windowed
sinc lowpass.

Counterpart of ``audiogpt_tpu/dsp/resample.py``, with the same taps and the
same outputs. The JAX package writes it as one convolution of the signal
upsampled by input dilation (zero-stuffed), strided by M. At the tool's
common ratio, 44.1 → 16 kHz (L = 160, M = 441), that form would filter 160
zeros for every sample: a 30 s clip becomes 212 M samples against 21 169
taps. Here it is the polyphase form of the same sums: output ``q·L + c``
takes the input window that starts at ``q·M`` through the taps of phase
``c`` alone, so all L phases are one matrix product of the signal's
strided windows ``[.., Q, W]`` with a ``[W, L]`` filter matrix.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _kernel(up: int, down: int, zeros: int = 24,
            beta: float = 14.769656459379492) -> np.ndarray:
    """Kaiser-windowed sinc lowpass at cutoff min(1/up, 1/down)."""
    from scipy.signal import windows   # a second to import: only when used

    cutoff = 0.5 / max(up, down)
    half = zeros * max(up, down)
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = 2 * cutoff * np.sinc(2 * cutoff * n) \
        * windows.kaiser(2 * half + 1, beta)
    return (taps * up).astype(np.float32)


def _ratio(orig_sr: int, target_sr: int) -> tuple[int, int]:
    g = math.gcd(orig_sr, target_sr)
    return target_sr // g, orig_sr // g


def output_length(n: int, orig_sr: int, target_sr: int) -> int:
    up, down = _ratio(orig_sr, target_sr)
    return int(np.ceil(n * up / down))


@functools.lru_cache(maxsize=None)
def _phases(up: int, down: int) -> tuple[np.ndarray, int]:
    """The filter matrix ``G [W, up]`` and the window's start offset ``j0``:
    output ``q·up + c`` is ``Σ_t G[t, c] · x[q·down + j0 + t]``.

    The zero-stuffed form's output ``m`` sums ``taps[k]`` against the
    dilated signal at ``m·down + k - pad``, which holds ``x[i]`` where
    ``i·up = m·down + k - pad``; with ``m = q·up + c`` that is
    ``k = (i - q·down)·up + pad - c·down``."""
    taps = _kernel(up, down)
    k, pad = taps.shape[0], (taps.shape[0] - 1) // 2
    j0 = -(pad // up)                       # ceil(-pad / up)
    j1 = (k - 1 - pad + (up - 1) * down) // up
    t = np.arange(j1 - j0 + 1)[:, None]
    idx = (t + j0) * up + pad - np.arange(up)[None, :] * down
    valid = (idx >= 0) & (idx < k)
    g = np.where(valid, taps[np.clip(idx, 0, k - 1)], 0.0)
    return g.astype(np.float32), j0


def resample(x: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Resample ``[..., T]`` from ``orig_sr`` to ``target_sr`` (f32, on the
    tensor's device) → ``[..., output_length(T)]``."""
    if orig_sr == target_sr:
        return x
    up, down = _ratio(orig_sr, target_sr)
    g, j0 = _phases(up, down)
    width = g.shape[0]
    n_in = x.shape[-1]
    n_out = output_length(n_in, orig_sr, target_sr)
    # the zero-stuffed convolution's own length, padded with zeros to n_out
    n_conv = ((n_in - 1) * up + down) // down + 1
    q = -(-n_out // up)
    lead = -j0
    tail = max(0, (q - 1) * down + width - lead - n_in)
    xf = F.pad(x.reshape(-1, n_in).float(), (lead, tail))
    windows = xf.unfold(-1, width, down)[:, :q]          # [N, Q, W]
    weight = torch.from_numpy(g).to(x.device, non_blocking=True)
    y = (windows @ weight).reshape(xf.shape[0], q * up)[:, :n_out]
    if n_conv < n_out:
        y[:, n_conv:] = 0.0
    return y.reshape(*x.shape[:-1], n_out).to(x.dtype)
