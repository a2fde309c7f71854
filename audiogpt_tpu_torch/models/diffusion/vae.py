"""AutoencoderKL, the first-stage VAE of the latent diffusion, NCHW.

Counterpart of ``audiogpt_tpu/models/diffusion/vae.py`` (the reference's
``AutoencoderKL``, ``ldm/models/autoencoder.py:305``). Config matches
``txt2audio_args.yaml``: ch 128, ch_mult (1, 2, 2, 4), 2 res blocks, z = 4,
double_z. ``AttnBlock`` is a plain single-head product: it never takes the
flash kernel, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.diffusion.unet import GroupNorm32, conv3x3


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = (106, 212)
    in_channels: int = 1
    out_ch: int = 1
    z_channels: int = 4
    embed_dim: int = 4
    resolution: int = 848  # scalar tracker only (model.py:389)
    double_z: bool = True


def _norm(channels: int) -> GroupNorm32:
    return GroupNorm32(channels, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(channels)
        self.conv1 = conv3x3(channels, out_channels)
        self.norm2 = _norm(out_channels)
        self.conv2 = conv3x3(out_channels, out_channels)
        self.nin_shortcut = (nn.Conv2d(channels, out_channels, 1)
                             if channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (model.py:150)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).flatten(2).transpose(1, 2)     # [B, HW, C]
        k = self.k(h).flatten(2).transpose(1, 2)
        v = self.v(h).flatten(2).transpose(1, 2)
        w = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1)
        h = (w @ v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class DownsampleVAE(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # torch pads (0, 1, 0, 1): right/bottom only, then a VALID stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class UpsampleVAE(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = conv3x3(cfg.in_channels, cfg.ch)
        ch, res = cfg.ch, cfg.resolution
        for level, mult in enumerate(cfg.ch_mult):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_block_{i}",
                                ResnetBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
                if res in cfg.attn_resolutions:
                    self.add_module(f"down_{level}_attn_{i}", AttnBlock(ch))
            if level != len(cfg.ch_mult) - 1:
                self.add_module(f"down_{level}_downsample", DownsampleVAE(ch))
                res //= 2
        self.mid_block_1 = ResnetBlock(ch, ch)
        self.mid_attn_1 = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch)
        self.norm_out = _norm(ch)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = conv3x3(ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.conv_in(x)
        for level in range(len(cfg.ch_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
                attn = getattr(self, f"down_{level}_attn_{i}", None)
                if attn is not None:
                    h = attn(h)
            if level != len(cfg.ch_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.ch_mult)
        ch = cfg.ch * cfg.ch_mult[-1]
        res = cfg.resolution // 2 ** (n - 1)
        self.conv_in = conv3x3(cfg.z_channels, ch)
        self.mid_block_1 = ResnetBlock(ch, ch)
        self.mid_attn_1 = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch)
        for level in reversed(range(n)):
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{i}",
                                ResnetBlock(ch, cfg.ch * cfg.ch_mult[level]))
                ch = cfg.ch * cfg.ch_mult[level]
                if res in cfg.attn_resolutions:
                    self.add_module(f"up_{level}_attn_{i}", AttnBlock(ch))
            if level != 0:
                self.add_module(f"up_{level}_upsample", UpsampleVAE(ch))
                res *= 2
        self.norm_out = _norm(ch)
        self.conv_out = conv3x3(ch, cfg.out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for level in reversed(range(len(cfg.ch_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
                attn = getattr(self, f"up_{level}_attn_{i}", None)
                if attn is not None:
                    h = attn(h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class GaussianMoments(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, noise: torch.Generator | torch.Tensor | None = None
               ) -> torch.Tensor:
        """mean + std · ε, ε drawn from the generator ``noise`` or given
        (a replayed draw of the mean's shape)."""
        std = torch.exp(0.5 * self.logvar.clamp(-30.0, 20.0))
        if not isinstance(noise, torch.Tensor):
            noise = torch.randn(self.mean.shape, generator=noise,
                                device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        logvar = self.logvar.clamp(-30.0, 20.0)
        return 0.5 * torch.sum(self.mean ** 2 + logvar.exp() - 1.0 - logvar,
                               dim=(1, 2, 3))


class AutoencoderKL(nn.Module):
    """mel [B, 1, n_mels, frames] ↔ latent [B, z, n_mels/f, frames/f]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.quant_conv = nn.Conv2d(z_out, 2 * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode(self, x: torch.Tensor) -> GaussianMoments:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return GaussianMoments(mean, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                sample_posterior: bool = False):
        post = self.encode(x)
        z = post.sample(generator) if sample_posterior else post.mode()
        return self.decode(z), post
