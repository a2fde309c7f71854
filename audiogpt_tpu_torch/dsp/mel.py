"""Mel filterbanks and the named log-mel specs.

Counterpart of ``audiogpt_tpu/dsp/mel.py:38-175``. The filterbank is the JAX
package's numpy, copied (librosa's ``filters.mel``: Slaney mel scale,
triangular filters, Slaney area normalization). Each model family's
frontend is a named :class:`MelSpec`:

  * ``LDM_MEL_16K``  — Make-An-Audio ``TRANSFORMS_16000`` (sr 16k, nfft 1024,
    hop 256, 80 mels, 125–7600 Hz, power 1, log10; then
    :func:`ldm_normalize`)
  * ``PANNS_MEL_32K`` — the PANN / Cnn14 frontend (sr 32k, nfft 1024, hop
    320, 64 mels, 50–14000 Hz, power 2, 10·log10(max(x, 1e-10)), reflect
    padding)
  * ``HTSAT_MEL_48K``, ``CAPTION_MEL_32K``, ``NEURALSEQ_MEL_22K``,
    ``NEURALSEQ_MEL_24K``, ``WHISPER_MEL_16K`` — the other families' specs
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from audiogpt_tpu_torch.dsp.stft import spectrogram

_F_SP = 200.0 / 3  # Hz per mel below the break
_BRK_HZ = 1000.0
_BRK_MEL = _BRK_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    mel = f / _F_SP
    log_t = f >= _BRK_HZ
    return np.where(log_t, _BRK_MEL + np.log(np.maximum(f, 1e-10) / _BRK_HZ)
                    / _LOGSTEP, mel)


def _mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f = m * _F_SP
    log_t = m >= _BRK_MEL
    return np.where(log_t, _BRK_HZ * np.exp(_LOGSTEP * (m - _BRK_MEL)), f)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank ``[n_fft//2+1, n_mels]`` (transposed vs.
    librosa so the mel projection is a plain right-matmul)."""
    fmax = fmax if fmax is not None else sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [n_mels+2, n_bins]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # [n_mels, n_bins]

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.T.astype(np.float32)  # [n_bins, n_mels]


@dataclasses.dataclass(frozen=True)
class MelSpec:
    sr: int
    n_fft: int
    hop: int
    win_length: int
    n_mels: int
    fmin: float
    fmax: float
    power: float = 1.0          # 1 = magnitude, 2 = power spectrogram
    pad_mode: str = "constant"  # librosa default vs torchlibrosa 'reflect'
    log: str = "log10"          # 'log10' | 'db10' | 'db20' | 'none'
    amin: float = 1e-5

    def filterbank(self) -> np.ndarray:
        return mel_filterbank(self.sr, self.n_fft, self.n_mels, self.fmin,
                              self.fmax)

    @property
    def frames_per_second(self) -> float:
        return self.sr / self.hop


LDM_MEL_16K = MelSpec(16000, 1024, 256, 1024, 80, 125.0, 7600.0,
                      power=1.0, pad_mode="constant", log="log10", amin=1e-5)
PANNS_MEL_32K = MelSpec(32000, 1024, 320, 1024, 64, 50.0, 14000.0,
                        power=2.0, pad_mode="reflect", log="db10", amin=1e-10)
HTSAT_MEL_48K = MelSpec(48000, 1024, 480, 1024, 64, 50.0, 14000.0,
                        power=2.0, pad_mode="reflect", log="db10", amin=1e-10)
CAPTION_MEL_32K = PANNS_MEL_32K
NEURALSEQ_MEL_22K = MelSpec(22050, 1024, 256, 1024, 80, 80.0, 7600.0,
                            power=1.0, pad_mode="constant", log="log10",
                            amin=1e-5)
NEURALSEQ_MEL_24K = MelSpec(24000, 512, 128, 512, 80, 30.0, 12000.0,
                            power=1.0, pad_mode="constant", log="log10",
                            amin=1e-5)
WHISPER_MEL_16K = MelSpec(16000, 400, 160, 400, 80, 0.0, 8000.0,
                          power=2.0, pad_mode="reflect", log="log10",
                          amin=1e-10)


def log_mel(x: torch.Tensor, spec: MelSpec) -> torch.Tensor:
    """Waveform ``[..., T]`` → log-mel ``[..., frames, n_mels]``, f32."""
    s = spectrogram(x, spec.n_fft, spec.hop, spec.win_length, center=True,
                    pad_mode=spec.pad_mode, power=spec.power)
    fb = torch.from_numpy(spec.filterbank()).to(s.device, non_blocking=True)
    mel = s @ fb
    if spec.log == "none":
        return mel
    clamped = torch.clamp_min(mel, spec.amin)
    if spec.log == "log10":
        return torch.log10(clamped)
    if spec.log == "db10":
        return 10.0 * torch.log10(clamped)
    if spec.log == "db20":
        return 20.0 * torch.log10(clamped)
    raise ValueError(spec.log)


def ldm_normalize(log10_mel: torch.Tensor) -> torch.Tensor:
    """TRANSFORMS_16000 tail: 20*log10(mel) − 20 + 100, /100, clip [0,1]."""
    return torch.clamp((log10_mel * 20.0 - 20.0 + 100.0) / 100.0, 0.0, 1.0)


def ldm_denormalize(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`ldm_normalize` back to log10-mel."""
    return (x * 100.0 - 100.0 + 20.0) / 20.0


def ldm_mel(x: torch.Tensor) -> torch.Tensor:
    """Full Make-An-Audio frontend: wav 16k → normalized mel in [0, 1],
    ``[..., frames, 80]``."""
    return ldm_normalize(log_mel(x, LDM_MEL_16K))
