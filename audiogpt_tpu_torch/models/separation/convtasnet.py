"""Conv-TasNet — time-domain speech enhancement (n_src = 1) and separation
(n_src = 2), NCW.

Counterpart of ``audiogpt_tpu/models/separation/convtasnet.py:27-244`` (the
reference's ESPnet ``SeparateSpeech`` wrappers, ``audio-chatgpt.py:
957-1048``): a strided conv encoder → global layer norm → bottleneck → R × X
TCN blocks (1×1 conv, PReLU, gLN, dilated depthwise conv, PReLU, gLN;
residual and skip 1×1 convs) → PReLU → 1×1 mask conv (ReLU) → masked
features through a transposed-conv decoder, per source. gLN takes the valid
length: the statistics skip a bucket's zero padding. The decoder is
``conv_transpose1d`` with the JAX trims; the JAX package's polyphase form
was a TPU workaround. :func:`separate_streaming` keeps the JAX contract:
2.4 s segments at a 0.8 s hop in one batched call padded to a power-of-two
chunk count, a Hann (+ 1e-3) overlap-add in float64 on the host, and a
dyadic sample bucket for an input shorter than a segment.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ConvTasNetConfig:
    n_src: int = 2
    enc_dim: int = 512        # N
    enc_kernel: int = 16      # L
    bottleneck: int = 128     # B
    hidden: int = 512         # H
    skip: int = 128           # Sc
    kernel: int = 3           # P
    n_blocks: int = 8         # X (dilations 1..2^7)
    n_repeats: int = 3        # R
    mask_act: str = "relu"
    sample_rate: int = 16000

    @property
    def stride(self) -> int:
        return self.enc_kernel // 2


class GlobalLayerNorm(nn.Module):
    """gLN over (channels, time) jointly; ``mask`` [B, 1, T] (1 = valid)
    keeps padded frames out of the statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is None:
            mean = x.mean(dim=(1, 2), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        else:
            n = mask.sum(dim=(1, 2), keepdim=True).clamp_min(1.0) \
                * x.shape[1]
            mean = (x * mask).sum(dim=(1, 2), keepdim=True) / n
            var = (((x - mean) * mask) ** 2).sum(dim=(1, 2),
                                                 keepdim=True) / n
        return (x - mean) * torch.rsqrt(var + 1e-8) * self.gamma[:, None] \
            + self.beta[:, None]


class PReLU(nn.Module):
    """One shared slope, the JAX parameter ``alpha``."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class TCNBlock(nn.Module):
    def __init__(self, bottleneck: int, hidden: int, skip: int, kernel: int,
                 dilation: int):
        super().__init__()
        self.conv1x1 = nn.Conv1d(bottleneck, hidden, 1)
        self.prelu1 = PReLU()
        self.norm1 = GlobalLayerNorm(hidden)
        self.dconv = nn.Conv1d(hidden, hidden, kernel, dilation=dilation,
                               padding=(kernel - 1) * dilation // 2,
                               groups=hidden)
        self.prelu2 = PReLU()
        self.norm2 = GlobalLayerNorm(hidden)
        self.res_conv = nn.Conv1d(hidden, bottleneck, 1)
        self.skip_conv = nn.Conv1d(hidden, skip, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        h = self.norm1(self.prelu1(self.conv1x1(x)), mask)
        h = self.norm2(self.prelu2(self.dconv(h)), mask)
        return x + self.res_conv(h), self.skip_conv(h)


class ConvTasNet(nn.Module):
    def __init__(self, cfg: ConvTasNetConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = nn.Conv1d(1, cfg.enc_dim, cfg.enc_kernel,
                                 stride=cfg.stride, bias=False)
        self.ln_in = GlobalLayerNorm(cfg.enc_dim)
        self.bottleneck = nn.Conv1d(cfg.enc_dim, cfg.bottleneck, 1)
        for r in range(cfg.n_repeats):
            for b in range(cfg.n_blocks):
                self.add_module(f"tcn_{r}_{b}", TCNBlock(
                    cfg.bottleneck, cfg.hidden, cfg.skip, cfg.kernel, 2 ** b))
        self.mask_prelu = PReLU()
        self.mask_conv = nn.Conv1d(cfg.skip, cfg.n_src * cfg.enc_dim, 1)
        # the JAX parameter [L, 1, N]; conv_transpose1d takes [N, 1, L]
        self.decoder_kernel = nn.Parameter(
            torch.randn(cfg.enc_kernel, 1, cfg.enc_dim) / cfg.enc_dim ** 0.5)

    def forward(self, wav: torch.Tensor,
                valid_len: torch.Tensor | None = None) -> torch.Tensor:
        """wav [B, T] → sources [B, n_src, T]. ``valid_len`` [B]: the real
        samples of each row of a padded bucket, whose frames alone set the
        norms' statistics."""
        cfg = self.cfg
        t_in, stride = wav.shape[-1], cfg.stride
        pad = (-(t_in - cfg.enc_kernel)) % stride
        w = F.relu(self.encoder(F.pad(wav, (0, pad))[:, None]))  # [B, N, F]
        frames = w.shape[-1]
        mask = None
        if valid_len is not None:
            nf = torch.ceil(valid_len.to(w.device) / stride).long()
            mask = (torch.arange(frames, device=w.device)[None]
                    < nf[:, None]).to(w.dtype)[:, None]       # [B, 1, F]
        h = self.bottleneck(self.ln_in(w, mask))
        skip_sum = 0.0
        for r in range(cfg.n_repeats):
            for b in range(cfg.n_blocks):
                h, skip = getattr(self, f"tcn_{r}_{b}")(h, mask)
                skip_sum = skip_sum + skip
        m = self.mask_conv(self.mask_prelu(skip_sum))
        m = F.relu(m) if cfg.mask_act == "relu" else torch.sigmoid(m)
        m = m.reshape(m.shape[0], cfg.n_src, cfg.enc_dim, frames)
        masked = (w[:, None] * m).reshape(-1, cfg.enc_dim, frames)
        y = F.conv_transpose1d(masked,
                               self.decoder_kernel.permute(2, 1, 0),
                               stride=stride)          # [B·S, 1, t_in + pad]
        return y[:, 0, :t_in].reshape(wav.shape[0], cfg.n_src, t_in)


@torch.inference_mode()
def separate_streaming(model: nn.Module, wav: np.ndarray,
                       segment_sec: float = 2.4, hop_sec: float = 0.8,
                       max_chunk_batch: int = 64) -> np.ndarray:
    """mix [T] → [n_src, T] by overlap-add of ``segment_sec`` chunks
    ``hop_sec`` apart (the reference tool's 2.4 s / 0.8 s contract,
    audio-chatgpt.py:976-987), on the device of ``model``'s parameters.
    ``model(x [B, T], valid_len [B])`` is ``ConvTasNet`` or ``SkiM``."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    sr = cfg.sample_rate
    seg, hop = int(segment_sec * sr), int(hop_sec * sr)
    t = len(wav)

    def run(x: np.ndarray, lens: np.ndarray) -> np.ndarray:
        return model(torch.from_numpy(x).to(dev),
                     torch.from_numpy(lens).to(dev)).cpu().numpy()

    if t <= seg:
        bucket = min(max(sr // 4, 1 << (max(t - 1, 1)).bit_length()), seg)
        padded = np.zeros((1, bucket), np.float32)
        padded[0, :t] = wav
        return run(padded, np.asarray([t], np.int32))[0][:, :t]

    starts = list(range(0, t - seg + hop, hop))
    chunks = np.zeros((len(starts), seg), np.float32)
    lens = np.zeros(len(starts), np.int32)
    for i, start in enumerate(starts):
        end = min(start + seg, t)
        chunks[i, : end - start] = wav[start:end]
        lens[i] = end - start

    # the chunk count padded to a power of two (a fixed set of batch shapes)
    n = len(starts)
    bucket = 1
    while bucket < min(n, max_chunk_batch):
        bucket *= 2
    outs = []
    for ofs in range(0, n, bucket):
        block, blens = chunks[ofs: ofs + bucket], lens[ofs: ofs + bucket]
        if block.shape[0] < bucket:
            short = bucket - block.shape[0]
            block = np.pad(block, ((0, short), (0, 0)))
            blens = np.pad(blens, (0, short))
        outs.append(run(block, blens))
    out_chunks = np.concatenate(outs, axis=0)[:n]   # [N, n_src, seg]

    acc = np.zeros((cfg.n_src, t), np.float64)
    norm = np.zeros(t, np.float64)
    win = np.hanning(seg) + 1e-3
    for i, start in enumerate(starts):
        end = min(start + seg, t)
        acc[:, start:end] += out_chunks[i][:, : end - start] \
            * win[: end - start]
        norm[start:end] += win[: end - start]
    return (acc / np.maximum(norm, 1e-8)).astype(np.float32)
