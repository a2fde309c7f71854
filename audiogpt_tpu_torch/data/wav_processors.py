"""Waveform pre-processors for binarization — the reference's
``data_gen/tts/wav_processors`` stage, without its external dependencies.

Counterpart of ``audiogpt_tpu/data/wav_processors.py``. Reference chain
(``wav_processors/common_processors.py`` + ``data_gen_utils.py:27``
``trim_long_silences``): sox convert/resample → edge silence trim
(librosa.effects.trim) → loudness normalization (pyloudnorm BS.1770 to −20
LUFS) → webrtcvad-based removal of long internal silences (30 ms windows,
moving-average smoothing, max 12 silent frames kept). As in the JAX
package the chain is numpy, with the port's polyphase resampler
(:mod:`dsp.resample`, on a device the caller names: ``None`` is the card)
and an adaptive energy VAD standing in for webrtcvad.

Processors are registered by name (``register_wav_processor``, the
reference's ``wav_processors/base_processor.py`` pattern) and composed
with :func:`apply_processors`; each takes and returns ``(wav, sr)``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

WAV_PROCESSORS: dict[str, Callable] = {}


def register_wav_processor(name: str):
    def deco(fn):
        WAV_PROCESSORS[name] = fn
        return fn
    return deco


def apply_processors(names, wav: np.ndarray, sr: int,
                     options: dict | None = None):
    """Run processors in order; each maps (wav, sr) → (wav, sr).
    ``options[name]`` holds per-processor kwargs."""
    options = options or {}
    for n in names:
        if n not in WAV_PROCESSORS:
            raise KeyError(f"unknown wav processor {n!r}; "
                           f"have {sorted(WAV_PROCESSORS)}")
        wav, sr = WAV_PROCESSORS[n](wav, sr, **options.get(n, {}))
    return wav, sr


@register_wav_processor("resample")
def resample_processor(wav: np.ndarray, sr: int, target_sr: int = 22050,
                       device=None):
    """Polyphase resample (the sox_resample step, a Kaiser sinc kernel) on
    ``device`` (``None``: the card)."""
    if sr == target_sr:
        return wav, sr
    import torch

    from audiogpt_tpu_torch.dsp.resample import resample
    from audiogpt_tpu_torch.engines.base import resolve_device

    x = torch.as_tensor(np.asarray(wav, np.float32),
                        device=resolve_device(device))
    return resample(x, sr, target_sr).cpu().numpy(), target_sr


def _frame_rms_db(wav: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = max(1 + (len(wav) - frame) // hop, 0)
    if n == 0:
        return np.full(1, -100.0)
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=1) + 1e-12)
    return 20.0 * np.log10(rms + 1e-12)


@register_wav_processor("trim_sil")
def trim_silence(wav: np.ndarray, sr: int, top_db: float = 60.0,
                 frame: int = 2048, hop: int = 512):
    """Trim leading/trailing silence relative to the peak frame
    (librosa.effects.trim semantics used by TrimSILProcessor)."""
    db = _frame_rms_db(wav, frame, hop)
    keep = np.nonzero(db > db.max() - top_db)[0]
    if len(keep) == 0:
        return wav[:frame], sr
    start = keep[0] * hop
    end = min(keep[-1] * hop + frame, len(wav))
    return wav[start:end], sr


@register_wav_processor("loudness_norm")
def loudness_normalize(wav: np.ndarray, sr: int, target_db: float = -20.0):
    """Normalize integrated loudness to ``target_db`` (the reference's
    pyloudnorm −20 LUFS step, approximated by active-frame RMS loudness:
    frames within 30 dB of peak count toward the average)."""
    db = _frame_rms_db(wav, 2048, 512)
    active = db[db > db.max() - 30.0]
    loudness = active.mean() if len(active) else db.max()
    gain = 10.0 ** ((target_db - loudness) / 20.0)
    out = wav * gain
    peak = np.abs(out).max()
    if peak > 1.0:
        out = out / peak
    return out.astype(np.float32), sr


@register_wav_processor("trim_long_sil")
def trim_long_silences(wav: np.ndarray, sr: int,
                       max_silence_frames: int = 12,
                       window_ms: int = 30,
                       smooth_width: int = 8,
                       threshold_db: float = -40.0):
    """Cap internal silences (``trim_long_silences``, data_gen_utils.py:27):
    30 ms energy-VAD flags → moving-average smoothing → binary dilation by
    ``max_silence_frames`` → drop still-silent samples. Energy VAD replaces
    webrtcvad (external C wheel)."""
    spw = (window_ms * sr) // 1000
    n = len(wav) - (len(wav) % spw)
    if n == 0:
        return wav, sr
    w = wav[:n]
    frames = w.reshape(-1, spw)
    db = 20.0 * np.log10(np.sqrt((frames ** 2).mean(1)) + 1e-12)
    ref = max(db.max(), -35.0)
    voice = (db > ref + threshold_db).astype(np.float32)
    # moving-average smoothing
    k = np.ones(smooth_width) / smooth_width
    voice = np.convolve(voice, k, mode="same") > 0.5 / smooth_width
    # dilate with a centered structuring element (reference
    # binary_dilation(mask, ones(vad_max_silence_length + 1))): ~half the
    # window extends to each side, so a silent gap is kept only up to
    # max_silence_frames TOTAL — not per side
    mask = voice.copy()
    left = max_silence_frames // 2
    right = max_silence_frames - left
    for s in range(1, right + 1):
        mask[s:] |= voice[:-s]        # voice to the left keeps s frames after
    for s in range(1, left + 1):
        mask[:-s] |= voice[s:]        # voice to the right keeps s frames before
    keep = np.repeat(mask, spw)
    out = w[keep]
    if len(out) == 0:
        return wav, sr
    return np.concatenate([out, wav[n:]]).astype(np.float32), sr
