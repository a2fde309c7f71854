"""WAV I/O: ``save_wav``, ``load_wav`` with mixdown and resampling
(librosa.load semantics), and the streaming header ``wav_stream_header``.

Counterpart of ``audiogpt_tpu/utils/audio_io.py:1-56``, resampling through the
port's ``dsp/resample.py``, so the ASR tool's load path imports no JAX.
"""

from __future__ import annotations

import struct

import numpy as np
import torch
from scipy.io import wavfile

from audiogpt_tpu_torch.dsp.resample import resample
from audiogpt_tpu_torch.engines.base import resolve_device


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    """Write 16-bit PCM, clipped to [-1, 1]."""
    wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))


def load_wav(path: str, sr: int | None = None,
             device: str | torch.device | None = None):
    """Returns (mono wav [T], float32 in [-1, 1] as numpy, sample_rate):
    channels are averaged. With ``sr`` the audio is resampled to it on
    ``device`` (``None`` is the card, and raises without one; a file
    already at ``sr`` needs no device)."""
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if sr is not None and sr != file_sr:
        x = torch.from_numpy(np.ascontiguousarray(wav))
        wav = resample(x.to(resolve_device(device)), file_sr, sr).cpu().numpy()
        file_sr = sr
    return wav, file_sr


def wav_stream_header(sr: int, channels: int = 1, bits: int = 16) -> bytes:
    """RIFF/WAVE header for a PCM stream of unknown length (chunk sizes
    0xFFFFFFFF, the streaming-WAV convention players accept); the server's
    ``/tts/stream`` writes it once, then raw PCM as it is synthesized."""
    byte_rate = sr * channels * bits // 8
    block_align = channels * bits // 8
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sr,
                                    byte_rate, block_align, bits)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))
