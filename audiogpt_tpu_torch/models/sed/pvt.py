"""PVT — Pyramid Vision Transformer v2 sound-event detection, the reference
SoundDetection tool's own net (``audio_detection/audio_infer/pytorch/
models.py:141``).

Counterpart of ``audiogpt_tpu/models/sed/pvt.py:27-158``: log-mel [B, T, 64]
→ four stages of overlapping patch embeds (k7 s4, then k3 s2; torch's
padding ``k // 3``) and blocks of spatial-reduction attention (keys and
values from an ``sr × sr`` unpadded conv, sr 8/4/2/1) and a mix-FFN (a 3×3
depthwise conv, exact GELU) → mean over the mel axis → framewise sigmoid →
32× nearest repeat, padded with the last frame to the mel frame count;
clipwise = the framewise mean. Tokens run as [B, H·W, C] in the JAX
package's row-major (time, mel) order.

The spatial-reduction attention is the slice's flash path: one head at
stage 0, Tq ≫ Tk and a key count that is no multiple of the kernel's key
tile (a 10 s clip: [1, 6400 → 100, 1, 64] and [1, 1600 → 100, 2, 64]).
``ops/attention.attention`` sends it to the Hopper kernel on the card where
Tq·Tk ≥ 256², as the JAX dispatch sends it to Pallas.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.dsp.mel import PANNS_MEL_32K, MelSpec, log_mel
from audiogpt_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class PVTConfig:
    classes_num: int = 527
    embed_dims: Sequence[int] = (64, 128, 320, 512)
    depths: Sequence[int] = (3, 4, 6, 3)
    num_heads: Sequence[int] = (1, 2, 5, 8)
    mlp_ratios: Sequence[int] = (8, 8, 4, 4)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    interpolate_ratio: int = 32
    sample_rate: int = 32000
    hop: int = 320
    mel: MelSpec = PANNS_MEL_32K


class OverlapPatchEmbed(nn.Module):
    """NCHW [B, C, H, W] → (tokens [B, H'·W', dim], (H', W'))."""

    def __init__(self, in_channels: int, dim: int, kernel: int, stride: int):
        super().__init__()
        # torch-exact padding (models.py:796): k7 → 2, k3 → 1
        self.proj = nn.Conv2d(in_channels, dim, kernel, stride=stride,
                              padding=kernel // 3)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        hw = x.shape[2:]
        return self.norm(x.flatten(2).transpose(1, 2)), hw


def _grid(x: torch.Tensor, hw) -> torch.Tensor:
    """tokens [B, H·W, C] → NCHW [B, C, H, W]."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *hw)


class SRAttention(nn.Module):
    """Spatial-reduction attention: keys and values from an ``sr × sr``
    VALID conv (torch's unpadded ``Conv2d(k=s=sr)``: the ragged edge is
    dropped) and a LayerNorm."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = nn.LayerNorm(dim, eps=1e-6)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        b, n, c = x.shape
        dh = c // self.heads
        q = self.q(x).reshape(b, n, self.heads, dh)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(self.sr(_grid(x, hw)).flatten(2)
                                 .transpose(1, 2))
        kv = self.kv(kv_in).reshape(b, kv_in.shape[1], 2, self.heads, dh)
        out = attention(q, kv[:, :, 0], kv[:, :, 1])
        return self.proj(out.reshape(b, n, c))


class MixFFN(nn.Module):
    """FFN with a 3×3 depthwise conv (PVTv2's positional signal)."""

    def __init__(self, dim: int, ratio: int):
        super().__init__()
        inner = dim * ratio
        self.fc1 = nn.Linear(dim, inner)
        self.dwconv = nn.Conv2d(inner, inner, 3, padding=1, groups=inner)
        self.fc2 = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        h = self.dwconv(_grid(self.fc1(x), hw)).flatten(2).transpose(1, 2)
        return self.fc2(F.gelu(h, approximate="none"))


class PVTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        return x + self.ffn(self.norm2(x), hw)


class PVTSED(nn.Module):
    """wav [B, T] @32 kHz → the output dict of ``SEDModel``. ``wav_len`` is
    taken for the engine's common contract and, as in JAX, not used."""

    def __init__(self, cfg: PVTConfig = PVTConfig()):
        super().__init__()
        self.cfg = cfg
        self.bn0 = nn.BatchNorm1d(cfg.mel.n_mels, eps=1e-5)
        ch = 1
        for i, (dim, depth, heads, mr, sr) in enumerate(zip(
                cfg.embed_dims, cfg.depths, cfg.num_heads, cfg.mlp_ratios,
                cfg.sr_ratios)):
            self.add_module(f"patch_embed{i}", OverlapPatchEmbed(
                ch, dim, 7 if i == 0 else 3, 4 if i == 0 else 2))
            for d in range(depth):
                self.add_module(f"stage{i}_block{d}",
                                PVTBlock(dim, heads, sr, mr))
            self.add_module(f"stage{i}_norm", nn.LayerNorm(dim, eps=1e-6))
            ch = dim
        self.fc_audioset = nn.Linear(ch, cfg.classes_num)

    def forward(self, wav: torch.Tensor,
                wav_len: torch.Tensor | None = None) -> dict:
        cfg = self.cfg
        mel = log_mel(wav, cfg.mel)                          # [B, T, 64]
        frames = mel.shape[1]
        # per-mel-bin batch norm (bn0 in the reference)
        x = self.bn0(mel.transpose(1, 2)).transpose(1, 2)[:, None]
        for i, depth in enumerate(cfg.depths):
            x, hw = getattr(self, f"patch_embed{i}")(x)
            for d in range(depth):
                x = getattr(self, f"stage{i}_block{d}")(x, hw)
            x = _grid(getattr(self, f"stage{i}_norm")(x), hw)
        x = x.mean(dim=3).transpose(1, 2)                    # [B, T', C]
        framewise = torch.sigmoid(self.fc_audioset(x))
        up = framewise.repeat_interleave(cfg.interpolate_ratio, dim=1)
        # pad (with the last frame) or trim to the mel frame count
        # (reference pad_framewise_output)
        if up.shape[1] < frames:
            up = torch.cat([up, up[:, -1:].expand(-1, frames - up.shape[1],
                                                  -1)], dim=1)
        return {"framewise_output": up[:, :frames],
                "clipwise_output": framewise.mean(1).clamp(1e-7, 1.0),
                "embedding": x.mean(1)}
