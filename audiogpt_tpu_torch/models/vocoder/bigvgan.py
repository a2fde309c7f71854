"""BigVGAN generator in NCW layout.

Counterpart of ``audiogpt_tpu/models/vocoder/bigvgan.py`` (the reference's
``BigVGAN``, ``Make_An_Audio/vocoder/bigvgan/models.py:133``): HiFi-GAN
topology with AMP blocks, whose snake/snakebeta activations are wrapped in
anti-aliased 2× up/downsampling. Every such activation is one launch of the
fused kernel (``ops/snake_aa.py``) on the card. Submodules carry the flax
scope names (``conv_pre``, ``up_0``, ``amp_0_0.SnakeAA_0``, ``act_post``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from audiogpt_tpu_torch.ops.conv import Conv1d, ConvTranspose1d
from audiogpt_tpu_torch.ops.snake_aa import snake_aa
from audiogpt_tpu_torch.registry import VOCODERS


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 80
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5),
                                                        (1, 3, 5))
    resblock: str = "1"
    activation: str = "snakebeta"   # 'snake' | 'snakebeta'
    snake_logscale: bool = True
    sample_rate: int = 16000

    @property
    def hop_size(self) -> int:
        return int(np.prod(self.upsample_rates))


class SnakeAA(nn.Module):
    """Anti-aliased snake/snakebeta, up2× → snake → down2×, on x [B, C, T].
    Per-channel α (and β for snakebeta), optionally log-scale."""

    def __init__(self, channels: int, variant: str = "snakebeta",
                 logscale: bool = True):
        super().__init__()
        init = torch.zeros if logscale else torch.ones
        self.logscale = logscale
        self.alpha = nn.Parameter(init(channels))
        self.beta = (nn.Parameter(init(channels)) if variant == "snakebeta"
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha
        beta = alpha if self.beta is None else self.beta
        if self.logscale:
            alpha, beta = alpha.exp(), beta.exp()
        return snake_aa(x, alpha, beta)


class AMPBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int], activation: str, logscale: bool):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"SnakeAA_{2 * i}",
                            SnakeAA(channels, activation, logscale))
            self.add_module(f"Conv1d_{2 * i}",
                            Conv1d(channels, channels, kernel_size, dilation=d))
            self.add_module(f"SnakeAA_{2 * i + 1}",
                            SnakeAA(channels, activation, logscale))
            self.add_module(f"Conv1d_{2 * i + 1}",
                            Conv1d(channels, channels, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            xt = getattr(self, f"SnakeAA_{2 * i}")(x)
            xt = getattr(self, f"Conv1d_{2 * i}")(xt)
            xt = getattr(self, f"SnakeAA_{2 * i + 1}")(xt)
            xt = getattr(self, f"Conv1d_{2 * i + 1}")(xt)
            x = x + xt
        return x


class AMPBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int], activation: str, logscale: bool):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"SnakeAA_{i}",
                            SnakeAA(channels, activation, logscale))
            self.add_module(f"Conv1d_{i}",
                            Conv1d(channels, channels, kernel_size, dilation=d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            xt = getattr(self, f"SnakeAA_{i}")(x)
            x = x + getattr(self, f"Conv1d_{i}")(xt)
        return x


@VOCODERS.register("bigvgan")
class BigVGANGenerator(nn.Module):
    """mel [B, n_mels, frames] → wav [B, frames · hop]."""

    def __init__(self, cfg: BigVGANConfig):
        super().__init__()
        self.cfg = cfg
        amp = AMPBlock1 if cfg.resblock == "1" else AMPBlock2
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.num_mels, ch, 7, padding=3)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            ch_out = cfg.upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"up_{i}", ConvTranspose1d(ch, ch_out, k, u,
                                                       padding=(k - u) // 2))
            ch = ch_out
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                self.add_module(f"amp_{i}_{j}", amp(ch, rk, tuple(rd),
                                                    cfg.activation,
                                                    cfg.snake_logscale))
        self.act_post = SnakeAA(ch, cfg.activation, cfg.snake_logscale)
        self.conv_post = Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n_res = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"up_{i}")(x)
            acc = getattr(self, f"amp_{i}_0")(x)
            for j in range(1, n_res):
                acc = acc + getattr(self, f"amp_{i}_{j}")(x)
            x = acc / n_res
        x = self.conv_post(self.act_post(x))
        return torch.tanh(x)[:, 0]
