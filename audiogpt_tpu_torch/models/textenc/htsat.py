"""HTSAT: the hierarchical token-semantic audio transformer, CLAP's Swin
audio tower.

Counterpart of ``audiogpt_tpu/models/textenc/htsat.py:33-330`` (the
reference's ``open_clap/htsat.py``, HTSAT-tiny): wav → the 48 kHz power
log-mel (``HTSAT_MEL_48K``) → the per-bin BatchNorm ``bn0`` (explicit
parameters) → ``reshape_wav2img`` (the time axis stretched by bicubic
``align_corners=True`` or cropped to ``spec_size · freq_ratio`` frames,
then ``freq_ratio`` time chunks stacked along frequency: a square image)
→ 4×4 patches → four Swin stages (windowed attention with a relative
position bias, shifted windows with the −100 boundary mask between
blocks, patch merging between stages) → LayerNorm → the mean over all
cells, projected into CLAP's space; with ``return_dict`` also the
token-semantic head's clip and frame probabilities.

The Swin runs channels-last ([B, H, W, C]), as in JAX. Every LayerNorm has
ε = 1e-5 and the MLP's GELU is the exact form. A window no smaller than
the grid becomes one full-grid window without shift (the reference's
clamp rule): the grid of each stage is known from the config, so each
block is built with its window, and its shift mask and relative-position
index are buffers made once. A window holds 64 tokens with a bias, so the
attention is the plain product, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.dsp.mel import HTSAT_MEL_48K, MelSpec, log_mel


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    mel: MelSpec = HTSAT_MEL_48K
    spec_size: int = 256            # Swin input image side
    patch: int = 4                  # patch size == patch stride
    window: int = 8
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (4, 8, 16, 32)
    mlp_ratio: int = 4
    num_classes: int = 527
    d_proj: int = 1024              # CLAP joint space (audio_projection out)
    project: bool = True            # apply the CLAP audio_projection MLP

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel.n_mels

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(win: torch.Tensor, w: int, b: int, h: int,
                    wd: int) -> torch.Tensor:
    x = win.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


@functools.lru_cache(maxsize=None)
def _rel_pos_index(w: int) -> np.ndarray:
    """Swin relative-position index [W², W²] into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return ((rel[0] + w - 1) * (2 * w - 1) + (rel[1] + w - 1)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(h: int, wd: int, win: int, shift: int) -> np.ndarray:
    """SW-MSA boundary mask [nW, W², W²], 0 or -100: after the cyclic
    roll, pairs that came from different image regions must not attend to
    each other."""
    img = np.zeros((h, wd), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // win, win, wd // win, win).transpose(
        0, 2, 1, 3).reshape(-1, win * win)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def reshape_wav2img(mel: torch.Tensor, spec_size: int,
                    freq_ratio: int) -> torch.Tensor:
    """[B, T, F] log-mel → [B, spec, spec, 1] Swin image: crop or stretch
    (bicubic, ``align_corners=True``, a = −0.75, clamped taps) T to
    ``spec · ratio`` frames, then stack ``freq_ratio`` time chunks along
    the frequency axis."""
    target_t = spec_size * freq_ratio
    mel = mel[:, :target_t]
    if mel.shape[1] < target_t:
        if mel.shape[1] == 1:
            mel = mel.repeat(1, target_t, 1)
        else:
            mel = F.interpolate(mel[:, None], size=(target_t, mel.shape[2]),
                                mode="bicubic", align_corners=True)[:, 0]
    b, t, f = mel.shape
    x = mel.transpose(1, 2).reshape(b, f, freq_ratio, t // freq_ratio)
    x = x.transpose(1, 2).reshape(b, freq_ratio * f, t // freq_ratio)
    return x[..., None]


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias on windows [n, W², C]; ``mask``
    is the SW-MSA boundary mask [nW, W², W²] or None."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias = nn.Parameter(
            0.02 * torch.randn((2 * window - 1) ** 2, heads))
        self.register_buffer("rel_index", torch.from_numpy(
            _rel_pos_index(window).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        n, l, _ = x.shape
        hd = self.dim // self.heads
        q, k, v = self.qkv(x).reshape(n, l, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)                               # [3][n, h, l, hd]
        logits = (q @ k.transpose(-1, -2)) * hd ** -0.5
        bias = self.rel_pos_bias[self.rel_index].reshape(l, l, self.heads)
        logits = logits + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(n // nw, nw, self.heads, l, l)
                      + mask[None, :, None]).reshape(n, self.heads, l, l)
        out = torch.softmax(logits, dim=-1) @ v          # [n, h, l, hd]
        return self.proj(out.transpose(1, 2).reshape(n, l, self.dim))


class SwinBlock(nn.Module):
    """One Swin block on [B, H, W, C] for a ``grid`` × ``grid`` input.
    A grid no larger than the window takes one full-grid window and no
    shift."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: int, grid: int):
        super().__init__()
        if grid <= window:
            window, shift = grid, 0
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)
        mask = torch.from_numpy(_shift_attn_mask(grid, grid, window, shift)) \
            if shift > 0 else None
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, wd, _ = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = _window_reverse(self.attn(_window_partition(y, w), self.mask),
                            w, b, h, wd)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    """2×2 merge in the reference's concat order h0w0, h1w0, h0w1, h1w1."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim_in, eps=1e-5)
        self.reduction = nn.Linear(4 * dim_in, dim_out, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class HTSATSwin(nn.Module):
    """The Swin core on the [B, spec, spec, 1] image: :meth:`features`
    gives the normed grid [B, SF, ST, C]; ``forward`` the dict of
    ``embedding`` [B, C], ``clipwise`` [B, classes] and ``framewise``
    [B, T', classes] (sigmoided)."""

    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch
        self.patch_proj = nn.Conv2d(1, cfg.embed_dim, p, stride=p)
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        dim, grid = cfg.embed_dim, cfg.spec_size // p
        self.stages = []
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            names = []
            for d in range(depth):
                shift = 0 if d % 2 == 0 else cfg.window // 2
                names.append(f"layer{i}_block{d}")
                self.add_module(names[-1], SwinBlock(
                    dim, heads, cfg.window, shift, cfg.mlp_ratio, grid))
            if i < len(cfg.depths) - 1:
                names.append(f"downsample{i}")
                self.add_module(names[-1], PatchMerging(dim, 2 * dim))
                dim, grid = 2 * dim, grid // 2
            self.stages += names
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        cfb = grid // cfg.freq_ratio
        self.tscam_conv = nn.Conv2d(dim, cfg.num_classes, (cfb, 3),
                                    padding=(0, 1))

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_proj(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        for name in self.stages:
            x = getattr(self, name)(x)
        return self.norm(x)

    def forward(self, img: torch.Tensor) -> dict:
        x = self.features(img)
        b, sf, st, c = x.shape
        fr = self.cfg.freq_ratio
        # the freq_ratio time chunks back onto the time axis, then the
        # (c_freq_bin, 3) conv over the whole frequency extent
        t = x.permute(0, 3, 1, 2).reshape(b, c, fr, sf // fr, st)
        t = t.transpose(2, 3).reshape(b, c, sf // fr, fr * st)
        logits = self.tscam_conv(t)[:, :, 0].transpose(1, 2)  # [B, T', K]
        framewise = torch.sigmoid(logits).repeat_interleave(
            8 * self.cfg.patch, dim=1)
        return {"embedding": x.mean(dim=(1, 2)),
                "clipwise": torch.sigmoid(logits.mean(1)),
                "framewise": framewise}


class AudioProjection(nn.Module):
    """CLAP ``audio_projection``: Linear → ReLU → Linear."""

    def __init__(self, d_in: int, d_proj: int):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_proj)
        self.fc2 = nn.Linear(d_proj, d_proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class HTSATAudioEncoder(nn.Module):
    """wav [B, T] at ``cfg.mel.sr`` → CLAP audio embedding [B, d_proj], or
    with ``return_dict`` the Swin's outputs and ``projected``."""

    def __init__(self, cfg: HTSATConfig = HTSATConfig()):
        super().__init__()
        self.cfg = cfg
        f = cfg.mel.n_mels
        self.bn0_mean = nn.Parameter(torch.zeros(f))
        self.bn0_var = nn.Parameter(torch.ones(f))
        self.bn0_scale = nn.Parameter(torch.ones(f))
        self.bn0_bias = nn.Parameter(torch.zeros(f))
        self.swin = HTSATSwin(cfg)
        if cfg.project:
            self.projection = AudioProjection(cfg.num_features, cfg.d_proj)

    def image(self, wav: torch.Tensor) -> torch.Tensor:
        """The frontend: log-mel → bn0 → the Swin image [B, S, S, 1]."""
        mel = log_mel(wav, self.cfg.mel)
        mel = (mel - self.bn0_mean) * torch.rsqrt(self.bn0_var + 1e-5) \
            * self.bn0_scale + self.bn0_bias
        return reshape_wav2img(mel, self.cfg.spec_size, self.cfg.freq_ratio)

    def forward(self, wav: torch.Tensor, wav_len=None,
                return_dict: bool = False):
        img = self.image(wav)
        if return_dict:
            out = self.swin(img)
            if self.cfg.project:
                out["projected"] = self.projection(out["embedding"])
            return out
        emb = self.swin.features(img).mean(dim=(1, 2))
        return self.projection(emb) if self.cfg.project else emb
