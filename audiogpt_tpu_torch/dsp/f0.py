"""Fundamental-frequency (f0) estimation, the coarse pitch bins and the
continuous-wavelet (CWT) decomposition of log-f0.

Counterpart of ``audiogpt_tpu/dsp/f0.py`` (the reference extracts f0 with
parselmouth on the host, ``NeuralSeq/data_gen/tts/data_gen_utils.py``
``get_pitch``, and decomposes it with pycwt, ``NeuralSeq/utils/cwt.py``):

* :func:`estimate_f0` is the JAX package's normalized-autocorrelation
  tracker (frames → rFFT autocorrelation → peak pick with parabolic
  interpolation) in torch, on the wav's device (cuFFT on the card), next to
  the mel frontend;
* :func:`f0_to_coarse`, :func:`continuous_f0`, :func:`cwt_lf0` and
  :func:`norm_scale` build the binarizer's targets in numpy on the host, as
  in JAX: a Mexican-hat CWT with the reference's scale layout (dt 0.005,
  dj 1, s0 2·dt, J 9 → 10 scales);
* :func:`inverse_cwt` and :func:`cwt2f0` are FastSpeech2's
  ``pitch_type="cwt"`` recomposition in torch (weights ``(i + 1 +
  2.5)^-2.5``, re-standardised over the frames, back to Hz by the
  utterance's log-f0 mean and std).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# f0 → coarse bucket constants (pitch_utils.py:15-19)
F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
_F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
_F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)


def estimate_f0(wav: torch.Tensor, sr: int = 22050, hop: int = 256,
                win: int = 1024, fmin: float = 80.0, fmax: float = 750.0,
                voicing_threshold: float = 0.45
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized-autocorrelation f0 tracker on ``wav`` [..., T] (f32, on
    its device) → (f0 Hz, 0 where unvoiced; the voiced mask as f32), each
    [..., ceil(T / hop)] to line up with the mel frames (centre-padded).

    The lag is the argmax of the normalized autocorrelation over the lags
    of [fmin, fmax], the first where two tie (as ``jnp.argmax``), refined
    by a parabola through it and its neighbours."""
    n_frames = (wav.shape[-1] + hop - 1) // hop
    pad = win // 2
    x = torch.nn.functional.pad(wav.float(), (pad, pad + n_frames * hop))
    frames = x.unfold(-1, win, hop)[..., :n_frames, :]       # [..., F, win]
    frames = frames - frames.mean(-1, keepdim=True)

    # autocorrelation through an rFFT zero-padded to 2·win (linear, not
    # circular, up to lag win)
    n_fft = 2 * win
    spec = torch.fft.rfft(frames, n=n_fft)
    acf = torch.fft.irfft(spec * spec.conj(), n=n_fft)[..., :win]
    energy = acf[..., :1]
    nacf = acf / energy.clamp_min(1e-10)

    lag_min = int(sr / fmax)
    lag_max = min(int(sr / fmin), win - 2)
    lags = torch.arange(win, device=wav.device)
    valid = (lags >= lag_min) & (lags <= lag_max)
    scores = torch.where(valid, nacf, -1.0)
    best = scores.argmax(-1, keepdim=True)                  # [..., F, 1]

    # parabolic interpolation around the peak for sub-sample lag accuracy
    y0 = nacf.gather(-1, (best - 1).clamp_min(0))[..., 0]
    y1 = nacf.gather(-1, best)[..., 0]
    y2 = nacf.gather(-1, (best + 1).clamp_max(win - 1))[..., 0]
    denom = y0 - 2.0 * y1 + y2
    curved = denom.abs() > 1e-8
    delta = torch.where(curved, 0.5 * (y0 - y2)
                        / torch.where(curved, denom, 1.0), 0.0)
    lag = best[..., 0].float() + delta.clamp(-0.5, 0.5)

    f0 = sr / lag.clamp_min(1.0)
    voiced = (y1 > voicing_threshold) & (energy[..., 0] > 1e-7) \
        & (f0 >= fmin) & (f0 <= fmax)
    return torch.where(voiced, f0, 0.0), voiced.float()


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Quantize Hz → 256 mel-spaced buckets (pitch_utils.py:22-31)."""
    f0 = np.asarray(f0, np.float64)
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    pos = f0_mel > 0
    f0_mel[pos] = (f0_mel[pos] - _F0_MEL_MIN) * (F0_BIN - 2) / \
        (_F0_MEL_MAX - _F0_MEL_MIN) + 1.0
    f0_mel = np.clip(f0_mel, 1.0, F0_BIN - 1)
    return np.rint(f0_mel).astype(np.int32)


# ---------------------------------------------------------------------------
# Continuous f0 and its CWT (cwt.py)
# ---------------------------------------------------------------------------

def continuous_f0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(uv, continuous f0): hold-extend the edges, linearly interpolate the
    unvoiced gaps (cwt.py:convert_continuos_f0)."""
    f0 = np.asarray(f0, np.float64).copy()
    uv = (f0 != 0).astype(np.float32)
    nz = np.flatnonzero(f0)
    if nz.size == 0:
        return uv, f0
    f0[: nz[0]] = f0[nz[0]]
    f0[nz[-1]:] = f0[nz[-1]]
    nz = np.flatnonzero(f0)
    cont = np.interp(np.arange(len(f0)), nz, f0[nz])
    return uv, cont


def continuous_lf0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    uv, cont = continuous_f0(f0)
    return uv, np.log(np.maximum(cont, 1e-8))


# the reference's scale layout (cwt.py:60-64): Mexican hat, 10 dyadic scales
CWT_DT = 0.005
CWT_DJ = 1.0
CWT_S0 = 2 * CWT_DT
CWT_J = 9
CWT_SCALES = CWT_S0 * 2.0 ** (CWT_DJ * np.arange(CWT_J + 1))


def _mexican_hat_ft(w: np.ndarray) -> np.ndarray:
    """Fourier transform of the DOG(m=2) 'Mexican hat' mother wavelet
    (Torrence & Compo 1998, Table 1)."""
    m = 2
    norm = 1.0 / np.sqrt(math.gamma(m + 0.5))
    return norm * (w ** m) * np.exp(-0.5 * w ** 2) * (w > 0)


def cwt_lf0(lf0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mexican-hat CWT of a (normalized) log-f0 track → (W [T, 10], the
    scales), the layout of ``get_lf0_cwt`` (cwt.py:53-69)."""
    x = np.asarray(lf0, np.float64)
    n = len(x)
    n_fft = int(2 ** np.ceil(np.log2(n))) if n > 1 else 2
    x_hat = np.fft.fft(x, n_fft)
    w_k = 2.0 * np.pi * np.fft.fftfreq(n_fft, CWT_DT)

    out = np.empty((CWT_J + 1, n))
    for j, s in enumerate(CWT_SCALES):
        # T&C eq. 4 with the sqrt(2*pi*s/dt) energy normalization
        psi_hat = np.sqrt(2.0 * np.pi * s / CWT_DT) * _mexican_hat_ft(s * w_k)
        out[j] = np.real(np.fft.ifft(x_hat * np.conj(psi_hat)))[:n]
    return out.T, CWT_SCALES.copy()


def norm_scale(W: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Standardize each of the 10 scales (cwt.py:norm_scale)."""
    mean = W.mean(axis=0, keepdims=True)
    std = W.std(axis=0, keepdims=True)
    return (W - mean) / np.maximum(std, 1e-8), mean, std


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
