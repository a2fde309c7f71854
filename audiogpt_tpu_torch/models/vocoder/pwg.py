"""ParallelWaveGAN and MelGAN generators in NCW layout.

Counterpart of ``audiogpt_tpu/models/vocoder/pwg.py:36-200`` (the
reference's ``ParallelWaveGANGenerator``, ``parallel_wavegan.py:21``: a
noise-input WaveNet of gated tanh·sigmoid units conditioned on the
upsampled mel, with a skip-sum head; and ``MelGANGenerator``, ``melgan.py``:
transposed-conv upsampling with dilated residual stacks, tanh output). No
weight norm: converters fold it. Every flax ``nn.Conv`` is a bare
``torch.nn.Conv1d`` named like its scope (``first_conv``,
``block0.conv1x1_aux``, ``upsample_net.up0``, ``in_conv``,
``up0_stack1.conv1``); flax's SAME padding is torch's ``"same"`` for these
odd kernels. MelGAN's ``nn.ConvTranspose(padding="SAME")`` is
``ops/conv.py`` ``FlaxConvTranspose1d``.

PWG's input noise is a ``[B, T]`` tensor or a ``torch.Generator``; with
neither, a generator seeded with 0, as the JAX generator falls back to
``PRNGKey(0)`` (the JAX engine always does).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.ops.conv import FlaxConvTranspose1d
from audiogpt_tpu_torch.registry import VOCODERS


def _same_conv(cin: int, cout: int, k: int, dilation: int = 1,
               bias: bool = True) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, k, dilation=dilation, padding="same",
                     bias=bias)


# ---------------------------------------------------------------------------
# Parallel WaveGAN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PWGConfig:
    layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    aux_channels: int = 80
    aux_context_window: int = 2
    kernel_size: int = 3
    upsample_scales: Sequence[int] = (4, 4, 4, 4)
    sample_rate: int = 22050
    #: 'repeat' = context conv + nearest repeat; 'conv_in' = the
    #: reference's ConvInUpsampleNetwork (upsample.py:125), which
    #: pretrained PWG checkpoints need
    upsample: str = "repeat"

    @property
    def hop_size(self) -> int:
        return int(np.prod(self.upsample_scales))


class PWGResidualBlock(nn.Module):
    def __init__(self, cfg: PWGConfig, dilation: int):
        super().__init__()
        g = cfg.gate_channels
        self.conv = _same_conv(cfg.residual_channels, g, cfg.kernel_size,
                               dilation)
        self.conv1x1_aux = nn.Conv1d(cfg.aux_channels, g, 1, bias=False)
        self.conv1x1_out = nn.Conv1d(g // 2, cfg.residual_channels, 1)
        self.conv1x1_skip = nn.Conv1d(g // 2, cfg.skip_channels, 1)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        """x [B, R, T], c [B, A, T] → (residual, skip)."""
        a, b = (self.conv(x) + self.conv1x1_aux(c)).chunk(2, dim=1)
        z = torch.tanh(a) * torch.sigmoid(b)
        return (x + self.conv1x1_out(z)) * math.sqrt(0.5), \
            self.conv1x1_skip(z)


@VOCODERS.register("pwg")
class ConvInUpsample(nn.Module):
    """ConvInUpsampleNetwork (upsample.py:125): context conv over the mel,
    then per scale a nearest stretch in time and a one-channel (2s+1)
    smoothing conv shared across mel bins (bins folded into the batch)."""

    def __init__(self, cfg: PWGConfig):
        super().__init__()
        self.scales = tuple(cfg.upsample_scales)
        self.conv_in = _same_conv(cfg.aux_channels, cfg.aux_channels,
                                  2 * cfg.aux_context_window + 1, bias=False)
        for i, s in enumerate(self.scales):
            self.add_module(f"up{i}", _same_conv(1, 1, 2 * s + 1, bias=False))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        c = self.conv_in(mel)                                  # [B, A, T]
        for i, s in enumerate(self.scales):
            c = c.repeat_interleave(s, dim=-1)                 # Stretch2d
            b, a, t = c.shape
            c = getattr(self, f"up{i}")(c.reshape(b * a, 1, t)).reshape(b, a,
                                                                        t)
        return c


class PWGGenerator(nn.Module):
    """mel [B, A, frames] (+ noise [B, T]) → wav [B, T]; T = frames · hop."""

    def __init__(self, cfg: PWGConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.upsample == "conv_in":
            self.upsample_net = ConvInUpsample(cfg)
        else:
            self.aux_context = _same_conv(cfg.aux_channels, cfg.aux_channels,
                                          2 * cfg.aux_context_window + 1,
                                          bias=False)
        self.first_conv = nn.Conv1d(1, cfg.residual_channels, 1)
        per_stack = cfg.layers // cfg.stacks
        for i in range(cfg.layers):
            self.add_module(f"block{i}",
                            PWGResidualBlock(cfg, 2 ** (i % per_stack)))
        self.post1 = nn.Conv1d(cfg.skip_channels, cfg.skip_channels, 1)
        self.post2 = nn.Conv1d(cfg.skip_channels, 1, 1)

    def forward(self, mel: torch.Tensor,
                noise: torch.Tensor | torch.Generator | None = None
                ) -> torch.Tensor:
        cfg = self.cfg
        b, _, frames = mel.shape
        if not isinstance(noise, torch.Tensor):
            # f32 normals whatever the run dtype, as the JAX model draws them
            gen = noise if noise is not None else \
                torch.Generator(mel.device).manual_seed(0)
            noise = torch.randn((b, frames * cfg.hop_size), generator=gen,
                                device=mel.device)
        if cfg.upsample == "conv_in":
            c = self.upsample_net(mel)                         # [B, A, T]
        else:
            c = self.aux_context(mel).repeat_interleave(cfg.hop_size, dim=-1)
        x = self.first_conv(noise[:, None, :].to(self.first_conv.weight.dtype))
        skips = 0.0
        for i in range(cfg.layers):
            x, s = getattr(self, f"block{i}")(x, c)
            skips = skips + s
        h = torch.relu(skips * math.sqrt(1.0 / cfg.layers))
        h = torch.relu(self.post1(h))
        return self.post2(h)[:, 0]


# ---------------------------------------------------------------------------
# MelGAN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MelGANConfig:
    in_channels: int = 80
    channels: int = 512
    upsample_scales: Sequence[int] = (8, 8, 2, 2)
    stack_kernel_size: int = 3
    stacks: int = 3
    sample_rate: int = 22050

    @property
    def hop_size(self) -> int:
        return int(np.prod(self.upsample_scales))


class MelGANResidualStack(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        self.conv1 = _same_conv(channels, channels, kernel_size, dilation)
        self.conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.leaky_relu(x, 0.2))
        return x + self.conv2(F.leaky_relu(h, 0.2))


@VOCODERS.register("melgan")
class MelGANGenerator(nn.Module):
    """mel [B, M, frames] → wav [B, frames · hop]."""

    def __init__(self, cfg: MelGANConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        self.in_conv = _same_conv(cfg.in_channels, ch, 7)
        for i, scale in enumerate(cfg.upsample_scales):
            self.add_module(f"up{i}", FlaxConvTranspose1d(ch, ch // 2,
                                                          scale * 2, scale))
            ch //= 2
            for s in range(cfg.stacks):
                self.add_module(f"up{i}_stack{s}", MelGANResidualStack(
                    ch, cfg.stack_kernel_size, cfg.stack_kernel_size ** s))
        self.out_conv = _same_conv(ch, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.in_conv(mel)
        for i in range(len(cfg.upsample_scales)):
            x = getattr(self, f"up{i}")(F.leaky_relu(x, 0.2))
            for s in range(cfg.stacks):
                x = getattr(self, f"up{i}_stack{s}")(x)
        x = self.out_conv(F.leaky_relu(x, 0.2))
        return torch.tanh(x)[:, 0]
