"""STFT and spectrograms: framing → window → real FFT.

Counterpart of ``audiogpt_tpu/dsp/stft.py:25-138`` (librosa semantics: center
padding, hann analysis window padded to n_fft). The JAX package runs this
on XLA's FFT; here ``torch.fft.rfft`` (cuFFT on the card) does the
transform. Inputs are float32 ``[..., T]``; outputs are
``[..., frames, n_fft//2+1]``, time-major as in the JAX package. The
inverse, :func:`istft`, overlaps and adds the frames with ``F.fold``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audiogpt_tpu_torch.dsp.window import hann_window, pad_center


def n_frames(n_samples: int, hop: int, n_fft: int, center: bool = True) -> int:
    if center:
        return 1 + n_samples // hop
    return 1 + (n_samples - n_fft) // hop


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Frame ``[..., T]`` into ``[..., n_frames, frame_length]`` windows (a
    strided view)."""
    return x.unfold(-1, frame_length, hop)


def _pad_signal(x: torch.Tensor, n_fft: int, pad_mode: str) -> torch.Tensor:
    pad = n_fft // 2
    if pad_mode == "constant":
        return F.pad(x, (pad, pad))
    if pad_mode == "reflect":
        # torch reflects along the last axis of a [N, C, T] tensor only
        y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        return y.reshape(*x.shape[:-1], y.shape[-1])
    raise ValueError(f"pad_mode {pad_mode}")


def _window(n_fft: int, win_length: int | None,
            device: torch.device) -> torch.Tensor:
    # non_blocking: a blocking host-to-device copy would wait for the
    # device to drain the work queued before it
    return torch.from_numpy(pad_center(hann_window(win_length or n_fft),
                                       n_fft)).to(device, non_blocking=True)


def stft(x: torch.Tensor, n_fft: int, hop: int, win_length: int | None = None,
         center: bool = True, pad_mode: str = "constant") -> torch.Tensor:
    """Complex STFT, ``[..., T] -> [..., frames, n_fft//2+1]``."""
    window = _window(n_fft, win_length, x.device)
    if center:
        x = _pad_signal(x, n_fft, pad_mode)
    return torch.fft.rfft(frame(x, n_fft, hop) * window, dim=-1)


def spectrogram(x: torch.Tensor, n_fft: int, hop: int,
                win_length: int | None = None, center: bool = True,
                pad_mode: str = "constant",
                power: float = 1.0) -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram."""
    s = stft(x, n_fft, hop, win_length, center, pad_mode)
    mag2 = s.real * s.real + s.imag * s.imag
    if power == 2.0:
        return mag2
    if power == 1.0:
        return torch.sqrt(mag2)
    return mag2 ** (power / 2.0)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum ``[N, F, n_fft]`` frames placed ``hop`` apart → ``[N, n_fft +
    hop·(F − 1)]``."""
    n, num, n_fft = frames.shape
    out = F.fold(frames.transpose(1, 2), output_size=(1, n_fft + hop
                                                      * (num - 1)),
                 kernel_size=(1, n_fft), stride=(1, hop))
    return out.reshape(n, -1)


def istft(spec: torch.Tensor, n_fft: int, hop: int,
          win_length: int | None = None, center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add with window-sum-square
    normalisation (the NOLA inverse), ``[..., frames, n_fft//2+1]`` complex
    → ``[..., T]`` float32 (``audiogpt_tpu/dsp/stft.py:95-138``)."""
    window = _window(n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window  # [..., F, n]
    num = spec.shape[-2]
    sig = _overlap_add(frames.reshape(-1, num, n_fft), hop)
    wss = _overlap_add((window * window).expand(1, num, n_fft), hop)
    out = (sig / wss.clamp_min(1e-11)).reshape(*spec.shape[:-2], -1)
    if center:
        out = out[..., n_fft // 2: out.shape[-1] - n_fft // 2]
    if length is not None:
        out = out[..., :length]
        out = F.pad(out, (0, length - out.shape[-1]))
    return out.float()
