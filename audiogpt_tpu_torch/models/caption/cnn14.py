"""Cnn14 (PANN) audio backbone, NCHW.

Counterpart of ``audiogpt_tpu/models/caption/cnn14.py`` (the reference's
``audio_to_text/captioning/models/encoder.py:336-468``): six conv blocks
with 2×2 average pools, a mean over the mel axis, and max + mean pooling
over time. The same backbone is the CLAP audio tower
(``models/textenc/clap.py``). The JAX package's NHWC mel ``[B, T, 64, 1]``
(H = time, W = mel) is ``[B, 1, T, 64]`` here. Submodules carry the flax
scope names (``bn0``, ``conv_block1.conv1``, ``fc1``); BatchNorm runs with
its running statistics (inference).

Frontend: :data:`PANNS_MEL_32K` on the waveform, whatever its sample rate,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.dsp.mel import PANNS_MEL_32K, log_mel


@dataclasses.dataclass(frozen=True)
class Cnn14Config:
    mel_bins: int = 64
    channels: tuple = (64, 128, 256, 512, 1024, 2048)
    downsample_ratio: int = 32   # 5 × (2,2) pools on time axis
    classes_num: int = 527       # AudioSet (tagging head)


class ConvBlock(nn.Module):
    """(3×3 conv, no bias → BatchNorm → ReLU) × 2, then a pool×pool average
    pool that floors, as flax's VALID pool does."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(out_channels, eps=1e-5)

    def forward(self, x: torch.Tensor, pool: int = 2) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if pool > 1:
            x = F.avg_pool2d(x, pool)
        return x


class Cnn14Encoder(nn.Module):
    """waveform [B, T] → dict(attn_emb [B, frames/32, C], fc_emb [B, C],
    attn_emb_len [B], clipwise_logits / clipwise_output [B, 527] when
    ``with_head``)."""

    def __init__(self, cfg: Cnn14Config, with_head: bool = False):
        super().__init__()
        # the pool schedule (2 for the first five blocks, 1 for the last) is
        # what downsample_ratio=32 encodes: another stage count would desync
        # the feat_len masking
        if len(cfg.channels) != 6:
            raise ValueError(
                f"Cnn14Config.channels must have 6 stages (pool schedule "
                f"fixes downsample_ratio={cfg.downsample_ratio}); got "
                f"{len(cfg.channels)}")
        self.cfg = cfg
        self.with_head = with_head
        self.bn0 = nn.BatchNorm1d(PANNS_MEL_32K.n_mels, eps=1e-5)
        ch = 1
        for i, out in enumerate(cfg.channels):
            self.add_module(f"conv_block{i + 1}", ConvBlock(ch, out))
            ch = out
        self.fc1 = nn.Linear(ch, ch)
        if with_head:
            self.fc_audioset = nn.Linear(ch, cfg.classes_num)

    def forward(self, wav: torch.Tensor,
                wav_len: torch.Tensor | None = None) -> dict:
        cfg = self.cfg
        mel = log_mel(wav, PANNS_MEL_32K)                   # [B, T', 64]
        # bn0 normalises per mel bin
        x = self.bn0(mel.transpose(1, 2)).transpose(1, 2)[:, None]
        for i in range(len(cfg.channels)):
            x = getattr(self, f"conv_block{i + 1}")(x, pool=2 if i < 5 else 1)
        attn_emb = x.mean(dim=3).transpose(1, 2)            # [B, T'/32, C]

        b, t = attn_emb.shape[:2]
        if wav_len is None:
            feat_len = torch.full((b,), t, dtype=torch.int64,
                                  device=wav.device)
        else:
            feat_len = (wav_len // PANNS_MEL_32K.hop + 1) \
                // cfg.downsample_ratio
        mask = (torch.arange(t, device=wav.device)[None]
                < feat_len[:, None])[..., None]             # [B, T, 1]
        maskf = mask.to(attn_emb.dtype)
        x_mean = (attn_emb * maskf).sum(1) / maskf.sum(1).clamp_min(1.0)
        x_max = attn_emb.masked_fill(~mask, float("-inf")).amax(1)
        fc_emb = F.relu(self.fc1(x_max + x_mean))
        out = {"attn_emb": attn_emb, "fc_emb": fc_emb,
               "attn_emb_len": feat_len}
        if self.with_head:
            # PANN tagging head (audioset_tagging_cnn Cnn14): sigmoid logits
            out["clipwise_logits"] = self.fc_audioset(fc_emb)
            out["clipwise_output"] = torch.sigmoid(out["clipwise_logits"])
        return out
