"""Window functions (numpy-computed constants; windows are tiny).

Counterpart of ``audiogpt_tpu/dsp/window.py``, copied: the port imports
nothing from the JAX package.
"""

from __future__ import annotations

import numpy as np


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window. ``periodic=True`` matches scipy ``fftbins=True``, which is
    what librosa/torch use for STFT analysis windows."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` (librosa ``util.pad_center``)."""
    lpad = (size - len(window)) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad : lpad + len(window)] = window
    return out
