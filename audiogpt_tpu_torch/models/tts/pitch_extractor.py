"""PitchExtractor: mel → (f0, uv), the SVS engine's f0 for an NSF vocoder.

Counterpart of ``audiogpt_tpu/models/tts/pitch_extractor.py:23-74`` (the
reference's ``PitchExtractor``, ``NeuralSeq/modules/fastspeech/pe.py:119``:
a 3-layer conv prenet, a residual conv encoder and a 5-layer pitch predictor
with a uv head), used at SVS inference when ``pe_enable``
(``ds_e2e.py:42-44``). Frames whose mel is all zero are padding. The flax
``nn.LayerNorm`` defaults to ε = 1e-6, kept here.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from audiogpt_tpu_torch.models.tts.fastspeech2 import (
    ConvPredictor,
    FastSpeech2Config,
    conv_time,
    denorm_f0,
)


@dataclasses.dataclass(frozen=True)
class PitchExtractorConfig:
    n_mels: int = 80
    hidden: int = 256
    prenet_layers: int = 3
    conv_layers: int = 2
    predictor_layers: int = 5
    predictor_kernel: int = 5
    pitch_norm: str = "standard"
    f0_mean: float = 200.0
    f0_std: float = 60.0
    use_uv: bool = True

    @property
    def _fs2_like(self) -> FastSpeech2Config:
        # denorm_f0 reads these fields only
        return FastSpeech2Config(pitch_norm=self.pitch_norm,
                                 f0_mean=self.f0_mean, f0_std=self.f0_std,
                                 use_uv=self.use_uv)


class PitchExtractor(nn.Module):
    def __init__(self, cfg: PitchExtractorConfig = PitchExtractorConfig()):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        for i in range(cfg.prenet_layers):
            self.add_module(f"prenet{i}", nn.Conv1d(cfg.n_mels if i == 0
                                                    else h, h, 5,
                                                    padding="same"))
            self.add_module(f"prenet_ln{i}", nn.LayerNorm(h, eps=1e-6))
        self.prenet_out = nn.Linear(h, h)
        for i in range(cfg.conv_layers):
            self.add_module(f"enc{i}", nn.Conv1d(h, h, 3, padding="same"))
            self.add_module(f"enc_ln{i}", nn.LayerNorm(h, eps=1e-6))
        self.pitch_predictor = ConvPredictor(h, h, cfg.predictor_layers,
                                             cfg.predictor_kernel, 2,
                                             with_pos=True, pos_dim=h)

    def forward(self, mel: torch.Tensor) -> dict:
        """mel [B, T, M] → dict(pitch_pred [B, T, 2], f0_denorm_pred
        [B, T])."""
        cfg = self.cfg
        nonpad = (mel.abs().sum(-1) > 0).float()
        m = nonpad[..., None]
        x = mel
        for i in range(cfg.prenet_layers):
            x = torch.relu(conv_time(getattr(self, f"prenet{i}"), x))
            x = getattr(self, f"prenet_ln{i}")(x) * m
        x = self.prenet_out(x) * m
        for i in range(cfg.conv_layers):
            h = conv_time(getattr(self, f"enc{i}"), x)
            x = (x + torch.relu(getattr(self, f"enc_ln{i}")(h))) * m
        pitch_pred = self.pitch_predictor(x, nonpad=nonpad,
                                          pos_nonpad=nonpad)
        uv = (pitch_pred[..., 1] > 0).float() if cfg.use_uv else None
        f0 = denorm_f0(pitch_pred[..., 0], uv, cfg._fs2_like,
                       pitch_padding=nonpad == 0)
        return {"pitch_pred": pitch_pred, "f0_denorm_pred": f0}
