"""Target sound detection (TSD): the on- and offsets of a described sound.

Counterpart of ``audiogpt_tpu/models/sed/tsd.py:24-105`` (the reference's
CDur_CNN14, ``audio_detection/target_sound_detection/src/models.py:964``):
four PANN conv blocks with a rectangular pool schedule → frame features
(channel-major, as JAX flattens ``(channel, mel)``) concatenated with the
query embedding → bidirectional GRU → 2-way softmax per frame → linear
interpolation back to the input frames (half-pixel centres, as
``jax.image.resize``). The post-processing (binarise → median filter →
contiguous regions → seconds) is the JAX host code, copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from torch import nn

from audiogpt_tpu_torch.ops.rnn import GRU

_POOL_SCHEDULES = {
    8: ((2, 2), (2, 2), (2, 4), (1, 4)),
    4: ((2, 2), (2, 2), (1, 4), (1, 4)),
    2: ((2, 2), (1, 2), (1, 4), (1, 4)),
    0: ((1, 2), (1, 2), (1, 4), (1, 4)),
}


@dataclasses.dataclass(frozen=True)
class TSDConfig:
    mel_bins: int = 64
    embedding_dim: int = 128
    scale: int = 8                  # time_resolution 125 ← input 500 frames
    gru_hidden: int = 512
    channels: tuple = (64, 128, 256, 512)


class TSDModel(nn.Module):
    def __init__(self, cfg: TSDConfig):
        super().__init__()
        self.cfg = cfg
        ch, mel = 1, cfg.mel_bins
        for bi, (out, pool) in enumerate(zip(cfg.channels,
                                             _POOL_SCHEDULES[cfg.scale])):
            for i in (1, 2):
                self.add_module(f"b{bi}_conv{i}", nn.Conv2d(
                    ch if i == 1 else out, out, 3, padding=1, bias=False))
                self.add_module(f"b{bi}_bn{i}", nn.BatchNorm2d(out, eps=1e-5))
            ch, mel = out, mel // pool[1]
        self.gru = GRU(ch * mel + cfg.embedding_dim, cfg.gru_hidden,
                       bidirectional=True)
        self.fc = nn.Linear(2 * cfg.gru_hidden, 256)
        self.outputlayer = nn.Linear(256, 2)

    def forward(self, mel: torch.Tensor, embedding: torch.Tensor):
        """mel [B, T, M], embedding [B, E] → (decision_time [B, T'],
        decision_up [B, T, 2])."""
        cfg = self.cfg
        t_in = mel.shape[1]
        x = mel[:, None]                                    # [B, 1, T, M]
        for bi, pool in enumerate(_POOL_SCHEDULES[cfg.scale]):
            for i in (1, 2):
                x = F.relu(getattr(self, f"b{bi}_bn{i}")(
                    getattr(self, f"b{bi}_conv{i}")(x)))
            x = F.avg_pool2d(x, pool)
        b, c, t, m = x.shape
        x = x.transpose(1, 2).reshape(b, t, c * m)          # (channel, mel)
        x = torch.cat([x, embedding[:, None].expand(-1, t, -1)], dim=-1)
        x = self.fc(self.gru(x))
        decision_time = torch.softmax(self.outputlayer(x), dim=-1)
        up = F.interpolate(decision_time.transpose(1, 2), size=t_in,
                           mode="linear", align_corners=False)
        return decision_time[..., 0], up.transpose(1, 2)


def binarize(x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    return (x > threshold).astype(np.int32)


def median_filter(x: np.ndarray, window_size: int, threshold: float = 0.5):
    """src/utils.py:189 semantics."""
    x = binarize(x, threshold)
    if x.ndim == 3:
        size = (1, window_size, 1)
    elif x.ndim == 2 and x.shape[0] == 1:
        size = (1, window_size)
    else:
        size = (window_size, 1)
    return ndimage.median_filter(x, size=size)


def find_contiguous_regions(activity: np.ndarray) -> np.ndarray:
    change = np.logical_xor(activity[1:], activity[:-1]).nonzero()[0] + 1
    if activity[0]:
        change = np.r_[0, change]
    if activity[-1]:
        change = np.r_[change, activity.size]
    return change.reshape((-1, 2))


def decode_timestamps(probs: np.ndarray, frame_rate: float,
                      window_size: int = 1, threshold: float = 0.5):
    """probs [T] → [(onset_sec, offset_sec), ...]."""
    act = median_filter(probs[None], window_size, threshold)[0].astype(bool)
    if not act.any():
        return []
    return [(s / frame_rate, e / frame_rate)
            for s, e in find_contiguous_regions(act)]
