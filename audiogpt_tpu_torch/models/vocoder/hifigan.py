"""HiFi-GAN generator in NCW layout, with the optional NSF harmonic source.

Counterpart of ``audiogpt_tpu/models/vocoder/hifigan.py:31-174`` (the
reference's ``HifiGanGenerator``, ``NeuralSeq/modules/hifigan/hifigan.py:104``;
V1: upsample rates (8, 8, 2, 2), kernels (16, 16, 4, 4), 512 channels, MRF
kernels (3, 7, 11) × dilations (1, 3, 5)). Weight norm is folded before
loading. Leaky ReLU with slope 0.1 throughout, and the torch default 0.01
before ``conv_post`` as in the reference (``hifigan.py:172``). No snake:
neither TPU kernel runs here. Submodules carry the flax scope names
(``conv_pre``, ``up_0``, ``noise_conv_0``, ``res_0_0.Conv1d_0``,
``conv_post``).

The NSF source takes its random draws explicitly, a ``torch.Generator`` or
the draws themselves in the JAX package's layout (``init_phase``
[B, 1, H+1] uniform, ``normals`` [B, S, H+1]), so a test can replay the
draws of JAX's ``split(rng)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.ops.conv import Conv1d, ConvTranspose1d
from audiogpt_tpu_torch.registry import VOCODERS

LRELU_SLOPE = 0.1

#: NSF draws: a generator, or (init_phase [B, 1, H+1], normals [B, S, H+1])
Draws = torch.Generator | tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HifiGANConfig:
    in_channels: int = 80
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5),
                                                        (1, 3, 5))
    resblock: str = "1"
    use_nsf: bool = False            # reference `use_pitch_embed`
    sample_rate: int = 22050
    harmonic_num: int = 8
    sine_amp: float = 0.1
    noise_std: float = 0.003
    voiced_threshold: float = 0.0

    @property
    def hop_size(self) -> int:
        return int(np.prod(self.upsample_rates))


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class ResBlock1(nn.Module):
    """MRF residual block: per dilation, lrelu → dilated conv → lrelu →
    conv, added to the input."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"Conv1d_{2 * i}",
                            Conv1d(channels, channels, kernel_size, dilation=d))
            self.add_module(f"Conv1d_{2 * i + 1}",
                            Conv1d(channels, channels, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            xt = getattr(self, f"Conv1d_{2 * i}")(_lrelu(x))
            x = x + getattr(self, f"Conv1d_{2 * i + 1}")(_lrelu(xt))
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"Conv1d_{i}",
                            Conv1d(channels, channels, kernel_size, dilation=d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = x + getattr(self, f"Conv1d_{i}")(_lrelu(x))
        return x


def harmonic_source(f0: torch.Tensor, upsample: int, sample_rate: int,
                    harmonic_num: int, sine_amp: float, noise_std: float,
                    voiced_threshold: float, draws: Draws) -> torch.Tensor:
    """NSF harmonic excitation: the mean of harmonic sines where voiced and
    noise where not, through tanh. ``f0`` [B, frames] → [B, 1, frames ·
    upsample]. The phase is the running sum of the instantaneous frequency
    (mod 1), as the JAX package computes it (the reference's SineGen).

    The harmonics run as rows of [B, H+1, S], so the running sum is over
    the contiguous last axis: a sum over the middle axis of [B, S, H+1]
    takes PyTorch's outer-dimension scan, one serial pass of 262 144 steps
    at the app's width (45 ms on the card).

    The source is computed in f32 whatever ``f0``'s dtype, and returned in
    f32. In bf16 the running sum (≈ 2.7e4 cycles over 262 144 samples)
    would move in steps of 128 cycles and the phase would be noise; the
    JAX package's bf16 engine has that fault, which this port does not
    copy."""
    f0 = f0.float()
    b = f0.shape[0]
    f0_up = f0.repeat_interleave(upsample, dim=1)[:, None, :]   # [B, 1, S]
    harmonics = torch.arange(1, harmonic_num + 2, dtype=f0.dtype,
                             device=f0.device)[:, None]
    inst_freq = f0_up * harmonics / sample_rate                 # [B, H+1, S]
    if isinstance(draws, torch.Generator):
        init_phase = torch.rand((b, harmonic_num + 1, 1), generator=draws,
                                dtype=f0.dtype, device=f0.device)
        normals = torch.randn(inst_freq.shape, generator=draws,
                              dtype=f0.dtype, device=f0.device)
    else:
        init_phase, normals = (d.float().transpose(1, 2) for d in draws)
    phase = 2.0 * math.pi * (torch.remainder(inst_freq.cumsum(-1), 1.0)
                             + init_phase)
    uv = (f0_up > voiced_threshold).to(f0.dtype)
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    sines = sine_amp * torch.sin(phase) * uv + noise_amp * normals
    # the JAX package merges the harmonics by a fixed mean (the reference:
    # a learned tanh(linear)); the generator's noise convs follow
    return torch.tanh(sines.mean(1, keepdim=True))


@VOCODERS.register("hifigan")
class HifiGANGenerator(nn.Module):
    """mel [B, n_mels, frames] (+ f0 [B, frames] with ``use_nsf``) → wav
    [B, frames · hop]."""

    def __init__(self, cfg: HifiGANConfig):
        super().__init__()
        self.cfg = cfg
        res = ResBlock1 if cfg.resblock == "1" else ResBlock2
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.in_channels, ch, 7, padding=3)
        n_up = len(cfg.upsample_rates)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            ch_out = cfg.upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"up_{i}", ConvTranspose1d(ch, ch_out, k, u,
                                                       padding=(k - u) // 2))
            ch = ch_out
            if cfg.use_nsf:
                if i + 1 < n_up:
                    sf = int(np.prod(cfg.upsample_rates[i + 1:]))
                    conv = Conv1d(1, ch, sf * 2, stride=sf, padding=sf // 2)
                else:
                    conv = Conv1d(1, ch, 1, padding=0)
                self.add_module(f"noise_conv_{i}", conv)
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                self.add_module(f"res_{i}_{j}", res(ch, rk, tuple(rd)))
        self.conv_post = Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor | None = None,
                draws: Draws | None = None) -> torch.Tensor:
        """``draws``: the NSF source's randomness (see
        :func:`harmonic_source`); ``None`` seeds a generator with 0 on the
        mel's device, as the JAX generator falls back to ``PRNGKey(0)``."""
        cfg = self.cfg
        n_res = len(cfg.resblock_kernel_sizes)
        har = None
        if cfg.use_nsf and f0 is not None:
            if draws is None:
                draws = torch.Generator(mel.device).manual_seed(0)
            har = harmonic_source(f0, cfg.hop_size, cfg.sample_rate,
                                  cfg.harmonic_num, cfg.sine_amp,
                                  cfg.noise_std, cfg.voiced_threshold,
                                  draws).to(mel.dtype)
        x = self.conv_pre(mel)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"up_{i}")(_lrelu(x))
            if har is not None:
                src = getattr(self, f"noise_conv_{i}")(har)
                x = x + src[..., :x.shape[-1]]
            acc = getattr(self, f"res_{i}_0")(x)
            for j in range(1, n_res):
                acc = acc + getattr(self, f"res_{i}_{j}")(x)
            x = acc / n_res
        # the reference's final activation is F.leaky_relu with the torch
        # default slope 0.01, not LRELU_SLOPE (hifigan.py:164)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]
