"""Relative-window-position transformer encoder: the text encoder behind
PortaSpeech and SyntaSpeech (``encoder_type: rel_fft``).

Counterpart of ``audiogpt_tpu/ops/rel_attention.py:1-159`` (the
reference's ``RelTransformerEncoder``,
``NeuralSeq/modules/commons/rel_transformer.py``): a zero-initialised
conv prenet, then pre-LN layers of self-attention with learned relative
key and value embeddings over ±``window`` and a conv FFN, then a last
LayerNorm. With ``idx[i, j] = clip(j − i, −w, w) + w``, the relative key
term is ``q · emb_k[idx[i, j]] / √dk`` and the value term ``Σ_j attn[i, j]
· emb_v[idx[i, j]]``. Here the key term is ``q @ emb_kᵀ`` gathered by
``idx``, and the value term sums the weights of each relative position
(a scatter-add over ``idx``) before one product with ``emb_v``: no
``[T, T, dk]`` table. Padding is masked to −1e4, not −inf, and the
channel LayerNorm has ε = 1e-4, as in the reference. The attention adds a
relative term to its logits, so it takes the plain path, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.tts.fastspeech2 import conv_time


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels with ε 1e-4 and ``gamma`` / ``beta``."""

    def __init__(self, dim: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma \
            + self.beta


class RelWindowAttention(nn.Module):
    """Self-attention with relative key/value embeddings shared by the
    heads, clipped to ±``window``."""

    def __init__(self, dim: int, heads: int, window: int = 4):
        super().__init__()
        self.dim, self.heads, self.window = dim, heads, window
        dk = dim // heads
        self.conv_q = nn.Linear(dim, dim)
        self.conv_k = nn.Linear(dim, dim)
        self.conv_v = nn.Linear(dim, dim)
        self.conv_o = nn.Linear(dim, dim)
        self.emb_rel_k = nn.Parameter(torch.randn(2 * window + 1, dk)
                                      * dk ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(2 * window + 1, dk)
                                      * dk ** -0.5)

    def forward(self, x: torch.Tensor, nonpad: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h, dk, w = self.heads, d // self.heads, self.window

        def split(a):
            return a.reshape(b, t, h, dk).transpose(1, 2)   # [B, H, T, dk]

        q, k, v = split(self.conv_q(x)), split(self.conv_k(x)), \
            split(self.conv_v(x))
        pos = torch.arange(t, device=x.device)
        idx = (pos[None, :] - pos[:, None]).clamp(-w, w) + w   # [T, T]
        idx = idx.expand(b, h, t, t)
        scale = 1.0 / math.sqrt(dk)
        scores = (q @ k.transpose(-1, -2)) * scale
        scores = scores + torch.gather(q @ self.emb_rel_k.T, -1, idx) * scale
        mask = (nonpad[:, None, None, :] * nonpad[:, None, :, None]) > 0
        attn = torch.softmax(scores.masked_fill(~mask, -1e4), dim=-1)
        rel = torch.zeros(b, h, t, 2 * w + 1, device=x.device,
                          dtype=attn.dtype).scatter_add_(-1, idx, attn)
        out = attn @ v + rel @ self.emb_rel_v
        return self.conv_o(out.transpose(1, 2).reshape(b, t, d))


class ConvFFN(nn.Module):
    """conv(k) → relu → dense, masked before each."""

    def __init__(self, dim: int, filter_dim: int, kernel: int):
        super().__init__()
        self.conv_1 = nn.Conv1d(dim, filter_dim, kernel, padding="same")
        self.conv_2 = nn.Linear(filter_dim, dim)

    def forward(self, x: torch.Tensor, nonpad: torch.Tensor) -> torch.Tensor:
        m = nonpad[..., None]
        x = F.relu(conv_time(self.conv_1, x * m))
        return self.conv_2(x * m) * m


class ConvReluNorm(nn.Module):
    """Residual conv prenet: n×(conv → channel LN → relu) → a
    zero-initialised dense."""

    def __init__(self, dim: int, layers: int = 3, kernel: int = 5):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"conv_{i}", nn.Conv1d(dim, dim, kernel,
                                                   padding="same"))
            self.add_module(f"norm_{i}", ChannelLayerNorm(dim))
        self.proj = nn.Linear(dim, dim)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, nonpad: torch.Tensor) -> torch.Tensor:
        m = nonpad[..., None]
        h = x
        for i in range(self.layers):
            h = conv_time(getattr(self, f"conv_{i}"), h * m)
            h = F.relu(getattr(self, f"norm_{i}")(h))
        return (x + self.proj(h)) * m


class RelTransformerEncoder(nn.Module):
    """Embeddings [B, T, dim] and their non-padding mask → prenet →
    n×(pre-LN relative attention + pre-LN conv FFN) → last LN."""

    def __init__(self, dim: int = 192, filter_dim: int = 768, heads: int = 2,
                 layers: int = 4, kernel: int = 5, window: int = 4,
                 prenet: bool = True):
        super().__init__()
        self.layers = layers
        self.pre = ConvReluNorm(dim) if prenet else None
        for i in range(layers):
            self.add_module(f"ln1_{i}", ChannelLayerNorm(dim))
            self.add_module(f"attn_{i}", RelWindowAttention(dim, heads,
                                                            window))
            self.add_module(f"ln2_{i}", ChannelLayerNorm(dim))
            self.add_module(f"ffn_{i}", ConvFFN(dim, filter_dim, kernel))
        self.last_ln = ChannelLayerNorm(dim)

    def forward(self, x: torch.Tensor, nonpad: torch.Tensor) -> torch.Tensor:
        m = nonpad[..., None]
        if self.pre is not None:
            x = self.pre(x, nonpad)
        for i in range(self.layers):
            x = x * m
            h = getattr(self, f"ln1_{i}")(x)
            x = x + getattr(self, f"attn_{i}")(h, nonpad)
            h = getattr(self, f"ln2_{i}")(x)
            x = x + getattr(self, f"ffn_{i}")(h, nonpad)
        return self.last_ln(x) * m
