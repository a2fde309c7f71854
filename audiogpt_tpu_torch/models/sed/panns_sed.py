"""Sound-event detection with framewise output (AudioSet, 527 classes): the
PANN decision-level net on the Cnn14 backbone.

Counterpart of ``audiogpt_tpu/models/sed/panns_sed.py:36-86``: Cnn14 →
``fc_frame`` → sigmoid per frame → ×32 nearest repeat back to the mel
frame rate; clipwise = the framewise maximum. :func:`audioset_labels` reads
this package's own copy of the AudioSet label list
(``audiogpt_tpu_torch/data/audioset_labels.csv``); :func:`detect_events`
is the JAX host code, copied.
"""

from __future__ import annotations

import csv
import dataclasses
import functools
import os

import numpy as np
import torch
from torch import nn

from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config, Cnn14Encoder


@dataclasses.dataclass(frozen=True)
class SEDConfig:
    cnn14: Cnn14Config = Cnn14Config()
    classes_num: int = 527
    interpolate_ratio: int = 32
    sample_rate: int = 32000
    hop: int = 320


@functools.lru_cache(maxsize=1)
def audioset_labels() -> list[str]:
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data", "audioset_labels.csv")
    with open(path) as f:
        return [row["display_name"] for row in csv.DictReader(f)]


class SEDModel(nn.Module):
    """wav [B, T] @32 kHz → dict(framewise_output [B, frames, C],
    clipwise_output [B, C], embedding [B, 2048])."""

    def __init__(self, cfg: SEDConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Cnn14Encoder(cfg.cnn14)
        self.fc_frame = nn.Linear(cfg.cnn14.channels[-1], cfg.classes_num)

    def forward(self, wav: torch.Tensor,
                wav_len: torch.Tensor | None = None) -> dict:
        enc = self.backbone(wav, wav_len)
        framewise = torch.sigmoid(self.fc_frame(enc["attn_emb"]))
        return {
            # nearest 32× interpolation (models.py interpolate():204)
            "framewise_output": framewise.repeat_interleave(
                self.cfg.interpolate_ratio, dim=1),
            "clipwise_output": framewise.amax(1).clamp(1e-7, 1.0),
            "embedding": enc["fc_emb"],
        }


def detect_events(framewise: np.ndarray, labels: list[str] | None = None,
                  top_k: int = 10, frames_per_second: float = 100.0):
    """Top-k classes by peak framewise probability with their curves —
    the payload the reference plots (``audio-chatgpt.py:655-673``)."""
    labels = labels or audioset_labels()
    peak = framewise.max(axis=0)
    idx = np.argsort(peak)[::-1][:top_k]
    return [
        {
            "label": labels[i] if i < len(labels) else str(i),
            "peak": float(peak[i]),
            "curve": framewise[:, i],
            "frames_per_second": frames_per_second,
        }
        for i in idx
    ]
