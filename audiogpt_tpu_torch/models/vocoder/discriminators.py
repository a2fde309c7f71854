"""HiFi-GAN discriminators for vocoder GAN training: MPD + MSD.

Counterpart of ``audiogpt_tpu/models/vocoder/discriminators.py`` (the
reference's ``NeuralSeq/modules/hifigan/hifigan.py``: ``DiscriminatorP``,
the period reshape and stacked 2-D convs; ``MultiPeriodDiscriminator``,
periods 2/3/5/7/11; ``DiscriminatorS``, strided grouped 1-D convs;
``MultiScaleDiscriminator``, 3 scales through an average pool). Plain convs,
no weight or spectral norm, as in JAX.

Layouts are torch's: a period discriminator sees the wav as [B, 1, T/p, p]
(JAX: NHWC [B, T/p, p, 1]) and a scale discriminator as [B, C, T]; the
feature maps are in those layouts, and the losses reduce over every element,
so they equal JAX's. Submodules carry the flax scope names (``mpd_{p}``,
``msd_{i}``, ``Conv_{n}``), so ``utils/jax_params.py`` maps a JAX tree on:
(5, 1) kernels HWIO → OIHW, grouped 1-D kernels ``[k, in/g, out]`` →
``[out, in/g, k]``. flax's ``padding="SAME"`` with a stride pads
``max((⌈T/s⌉ − 1)·s + k − T, 0)`` in all, the extra one after;
``nn.avg_pool(4, 2, "SAME")`` pads the same way and divides by 4 at the
edges too (the padded zeros count).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.ops.conv import pad_same
from audiogpt_tpu_torch.parallel.reduce import global_means


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class PeriodDiscriminator(nn.Module):
    """wav [B, T] → (logits [B, L], feature maps [B, C, T'/p, p])."""

    def __init__(self, period: int, channels: tuple = (32, 128, 512, 1024)):
        super().__init__()
        self.period = period
        cin = 1
        for i, ch in enumerate(channels):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, ch, (5, 1), (3, 1),
                                                   padding=(2, 0)))
            cin = ch
        n = len(channels)
        self.add_module(f"Conv_{n}", nn.Conv2d(cin, channels[-1], (5, 1),
                                               padding=(2, 0)))
        self.add_module(f"Conv_{n + 1}", nn.Conv2d(channels[-1], 1, (3, 1),
                                                   padding=(1, 0)))
        self.n = n

    def forward(self, wav: torch.Tensor):
        b, t = wav.shape
        p = self.period
        if t % p:
            # reflect only when the length is not a multiple of the period
            wav = F.pad(wav[:, None], (0, p - t % p), mode="reflect")[:, 0]
        x = wav.reshape(b, 1, -1, p)
        fmaps = []
        for i in range(self.n + 1):
            x = _lrelu(getattr(self, f"Conv_{i}")(x))
            fmaps.append(x)
        x = getattr(self, f"Conv_{self.n + 1}")(x)
        return x.reshape(b, -1), fmaps


class ScaleDiscriminator(nn.Module):
    """wav [B, T] → (logits [B, L], feature maps [B, C, T'])."""

    def __init__(self, channels: tuple = (128, 128, 256, 512, 1024, 1024,
                                          1024),
                 groups: tuple = (1, 4, 16, 16, 16, 16, 1),
                 kernel_sizes: tuple = (15, 41, 41, 41, 41, 41, 5),
                 strides: tuple = (1, 2, 2, 4, 4, 1, 1)):
        super().__init__()
        # zip semantics: a shorter channel stack truncates the schedules
        self.layers = list(zip(channels, kernel_sizes, strides, groups))
        cin = 1
        for i, (ch, k, s, g) in enumerate(self.layers):
            self.add_module(f"Conv_{i}", nn.Conv1d(cin, ch, k, s,
                                                   groups=min(g, cin)))
            cin = ch
        self.add_module(f"Conv_{len(self.layers)}", nn.Conv1d(cin, 1, 3))

    def forward(self, wav: torch.Tensor):
        x = wav[:, None]
        fmaps = []
        for i, (_, k, s, _) in enumerate(self.layers):
            x = _lrelu(getattr(self, f"Conv_{i}")(pad_same(x, k, s)))
            fmaps.append(x)
        x = getattr(self, f"Conv_{len(self.layers)}")(pad_same(x, 3, 1))
        return x.reshape(x.shape[0], -1), fmaps


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    periods: tuple = (2, 3, 5, 7, 11)
    scales: int = 3
    #: channel stacks (the reference's hifigan.py widths). A shorter
    #: ``scale_channels`` tuple truncates the kernel/stride/group
    #: schedules with it (zip semantics).
    period_channels: tuple = (32, 128, 512, 1024)
    scale_channels: tuple = (128, 128, 256, 512, 1024, 1024, 1024)
    #: the MSD stacks' group counts (each layer's is min(g, its input
    #: channels)); the JAX package's CPU tests set all-1s, since XLA's CPU
    #: grouped-conv backward is a slow path
    scale_groups: tuple = (1, 4, 16, 16, 16, 16, 1)


class HifiGANDiscriminator(nn.Module):
    """MPD + MSD: ``forward(wav [B, T]) -> (logits, fmaps)``, lists across
    all sub-discriminators (periods first, then scales)."""

    def __init__(self, cfg: DiscriminatorConfig | None = None):
        super().__init__()
        self.cfg = cfg = cfg or DiscriminatorConfig()
        for p in cfg.periods:
            self.add_module(f"mpd_{p}",
                            PeriodDiscriminator(p, tuple(cfg.period_channels)))
        for i in range(cfg.scales):
            self.add_module(f"msd_{i}", ScaleDiscriminator(
                tuple(cfg.scale_channels), tuple(cfg.scale_groups)))

    def forward(self, wav: torch.Tensor):
        logits, fmaps = [], []
        for p in self.cfg.periods:
            logit, f = getattr(self, f"mpd_{p}")(wav)
            logits.append(logit)
            fmaps.append(f)
        x = wav
        for i in range(self.cfg.scales):
            logit, f = getattr(self, f"msd_{i}")(x)
            logits.append(logit)
            fmaps.append(f)
            if i + 1 < self.cfg.scales:
                # avg-pool 4, stride 2 (hifigan.py MultiScale meanpools)
                x = F.avg_pool1d(pad_same(x[:, None], 4, 2), 4, 2)[:, 0]
        return logits, fmaps


def lsgan_d_loss(real_logits, fake_logits) -> torch.Tensor:
    """LSGAN discriminator objective (hifigan.py training loop); each mean
    over the global batch of a data-parallel run (all in one
    all-reduce)."""
    pairs = list(zip(real_logits, fake_logits))
    means = global_means(*((r - 1.0) ** 2 for r, _ in pairs),
                         *(f ** 2 for _, f in pairs))
    loss = 0.0
    for mr, mf in zip(means[:len(pairs)], means[len(pairs):]):
        loss = loss + mr + mf
    return loss


def lsgan_g_loss(fake_logits) -> torch.Tensor:
    loss = 0.0
    for m in global_means(*((f - 1.0) ** 2 for f in fake_logits)):
        loss = loss + m
    return loss


def feature_matching_loss(real_fmaps, fake_fmaps) -> torch.Tensor:
    """L1 across all discriminator feature maps (hifigan feature loss): the
    mean over maps of each map's mean."""
    diffs = [(r - f).abs() for rf, ff in zip(real_fmaps, fake_fmaps)
             for r, f in zip(rf, ff)]
    loss = 0.0
    for m in global_means(*diffs):
        loss = loss + m
    return loss / max(len(diffs), 1)
