"""LASSNet — language-queried audio source extraction, NCHW.

Counterpart of ``audiogpt_tpu/models/extraction/lassnet.py:25-142`` (the
reference's ``sound_extraction/model/LASSNet.py:7``): the BERT-mini CLS
state (→ linear → ReLU) conditions a 6-level residual U-Net
(``resunet_film.py:4``) through additive FiLM biases (``film.py:4``); the
U-Net predicts a sigmoid magnitude mask. The U-Net pads time to a multiple
of 64 and drops the top 2 frequency bins (``resunet_film.py:83-85``), and
restores both on output. The spectrogram is [B, T, F] at the boundary, as
in JAX; inside it is [B, 1, T, F]. The decoder's transposed conv is torch's
``ConvTranspose2d(k=3, s=2, padding=0)``, which the JAX package wrote in a
polyphase form for the TPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.textenc.bert import BertConfig, BertEncoder

BERT_MINI = BertConfig(hidden_size=256, num_layers=4, num_heads=4,
                       intermediate_size=1024)


@dataclasses.dataclass(frozen=True)
class LASSNetConfig:
    bert: BertConfig = BERT_MINI
    cond_dim: int = 256
    enc_channels: tuple = (32, 64, 128, 256, 384, 384)
    n_fft: int = 1024
    hop: int = 256
    sample_rate: int = 32000


class Film(nn.Module):
    """Additive FiLM (film.py:4): a per-channel bias = MLP(cond)."""

    def __init__(self, cond_dim: int, channels: int):
        super().__init__()
        self.l1 = nn.Linear(cond_dim, channels * 2)
        self.l2 = nn.Linear(channels * 2, channels)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        bias = F.relu(self.l2(F.relu(self.l1(cond))))
        return x + bias[:, :, None, None]


class ConvBlockResCond(nn.Module):
    """(BN → leaky ReLU → 3×3 conv → FiLM) × 2 plus the input, through a
    FiLMed 1×1 conv where the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, cond_dim: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.film1 = Film(cond_dim, out_channels)
        self.bn2 = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.film2 = Film(cond_dim, out_channels)
        if in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)
            self.film_res = Film(cond_dim, out_channels)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.leaky_relu(self.bn1(x), 0.01))
        h = self.film1(h, cond)
        h = self.conv2(F.leaky_relu(self.bn2(h), 0.01))
        h = self.film2(h, cond)
        if hasattr(self, "shortcut"):
            return self.film_res(self.shortcut(x), cond) + h
        return x + h


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, cond_dim: int):
        super().__init__()
        self.cb1 = ConvBlockResCond(in_channels, out_channels, cond_dim)
        self.cb2 = ConvBlockResCond(out_channels, out_channels, cond_dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor):
        x = self.cb2(self.cb1(x, cond), cond)
        return F.avg_pool2d(x, 2), x


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, cond_dim: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_channels, eps=1e-5)
        self.convT = nn.ConvTranspose2d(in_channels, out_channels, 3,
                                        stride=2, bias=False)
        self.cb2 = ConvBlockResCond(out_channels + skip_channels,
                                    out_channels, cond_dim)
        self.cb3 = ConvBlockResCond(out_channels, out_channels, cond_dim)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        h = self.convT(F.relu(self.bn1(x)))
        h = h[:, :, :-1]      # prune time (DecoderBlockRes2BCond.prune)
        h = torch.cat([h, skip], dim=1)
        return self.cb3(self.cb2(h, cond), cond)


class UNetResFiLM(nn.Module):
    def __init__(self, cfg: LASSNetConfig):
        super().__init__()
        self.cfg = cfg
        ch = 1
        for i, out in enumerate(cfg.enc_channels):
            self.add_module(f"enc_{i}", EncoderBlock(ch, out, cfg.cond_dim))
            ch = out
        self.center = ConvBlockResCond(ch, ch, cfg.cond_dim)
        for i, out in enumerate(reversed(cfg.enc_channels)):
            self.add_module(f"dec_{i}", DecoderBlock(ch, out, out,
                                                     cfg.cond_dim))
            ch = out
        self.after_cb = ConvBlockResCond(ch, 32, cfg.cond_dim)
        self.after_conv = nn.Conv2d(32, 1, 1)

    def forward(self, sp: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """sp [B, 1, T, F] → mask logits, same shape."""
        t0 = sp.shape[2]
        ds = 2 ** len(self.cfg.enc_channels)
        x = F.pad(sp, (0, 0, 0, (-t0) % ds))
        x = x[..., : x.shape[-1] - 2]                        # top 2 bins off
        skips = []
        for i in range(len(self.cfg.enc_channels)):
            x, skip = getattr(self, f"enc_{i}")(x, cond)
            skips.append(skip)
        x = self.center(x, cond)
        for i in range(len(self.cfg.enc_channels)):
            x = getattr(self, f"dec_{i}")(x, skips[-(i + 1)], cond)
        x = self.after_conv(self.after_cb(x, cond))
        return F.pad(x, (0, 2))[:, :, :t0]


class LASSNet(nn.Module):
    def __init__(self, cfg: LASSNetConfig):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = BertEncoder(cfg.bert)
        self.text_proj = nn.Linear(cfg.bert.hidden_size, cfg.cond_dim)
        self.unet = UNetResFiLM(cfg)

    def forward(self, sp: torch.Tensor, text_ids: torch.Tensor,
                text_mask: torch.Tensor | None = None) -> torch.Tensor:
        """sp [B, T, F] magnitude, text ids [B, L] → mask [B, T, F] in
        (0, 1)."""
        cond = self.text_cond(text_ids, text_mask)
        return self.masks(sp, cond)

    def text_cond(self, text_ids: torch.Tensor,
                  text_mask: torch.Tensor | None = None) -> torch.Tensor:
        """The U-Net's conditioning [B, cond_dim] from the query."""
        hidden = self.text_encoder(text_ids, text_mask)
        return F.relu(self.text_proj(hidden[:, 0]))

    def masks(self, sp: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """sp [B, T, F], cond [B, cond_dim] → mask [B, T, F]."""
        return torch.sigmoid(self.unet(sp[:, None], cond))[:, 0]
