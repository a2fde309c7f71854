"""T5 v1.1 / FLAN-T5 text encoder, weight-compatible with HF
``T5EncoderModel``.

Counterpart of ``audiogpt_tpu/models/textenc/t5.py:27-186``. The
reference's T5 / FLAN conditioners (``ldm/modules/encoders/modules.py:143``
``FrozenT5Embedder`` over google/t5-v1_1-large and ``:287``
``FrozenFLANEmbedder`` over google/flan-t5-large) wrap ``T5EncoderModel``
and return ``last_hidden_state`` as the cross-attention context. Both
checkpoints are the v1.1 architecture: RMS norms (no mean subtraction, no
bias), pre-norm residual blocks, no absolute position embedding but a
learned relative position bias that layer 0 owns and every layer adds,
the gated-GELU feed-forward, and unscaled dot-product attention (the
1/sqrt(d) is folded into the initialisation).

The submodules carry the flax scope names (``embed``, ``block_{i}.attn.
{q,k,v,o}``, ``block_0.attn.rel_bias``, ``attn_ln``, ``ff_ln``,
``wi_0`` / ``wi_1`` or ``wi``, ``wo``, ``final_ln``), so a JAX tree or an
``import_ckpt --family t5`` tree loads through ``load_jax_params``. The
position bias is a dense additive term on the scores, so the attention is
plain torch arithmetic, as JAX's einsum is: the flash kernel takes no part.

Tokenization: pass any callable ``text → ids`` as ``T5Conditioner``'s
``tokenizer``; ``text/sentencepiece.py`` ``SentencePieceUnigram`` reads
the ``spiece.model`` that ships with a checkpoint.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.engines.base import on_device, resolve_device, seeded


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024          # t5-v1_1-large / flan-t5-large
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    feed_forward: str = "gated-gelu"   # v1.1 / FLAN; "relu" = original t5

    @staticmethod
    def flan_t5_large() -> "T5Config":
        return T5Config()

    @staticmethod
    def t5_v1_1_large() -> "T5Config":
        return T5Config()


class T5LayerNorm(nn.Module):
    """RMS norm: x / sqrt(mean(x²) + eps) · w, the statistics in f32 and the
    normalised x cast back to its dtype before the weight."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """HF ``_relative_position_bucket`` (bidirectional): half the buckets
    for each sign, half of those exact, the rest log-spaced (float64
    ``np.log``, truncated by ``astype``, as JAX's copy)."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(n < max_exact, n, val_if_large)


@functools.lru_cache(maxsize=16)
def _buckets(length: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """The [L, L] bucket of key position k seen from query position q."""
    pos = np.arange(length)
    return relative_position_bucket(pos[None, :] - pos[:, None], num_buckets,
                                    max_distance)


class T5Attention(nn.Module):
    """Bias-free q/k/v/o, no 1/sqrt(d); with ``has_bias`` (layer 0 only) the
    module owns the relative bias table ``rel_bias`` [buckets, heads] and
    returns the [1, H, L, L] bias it makes, which the later layers add."""

    def __init__(self, cfg: T5Config, has_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.rel_bias = nn.Parameter(
            torch.randn(cfg.rel_buckets, cfg.num_heads) * 0.02) \
            if has_bias else None
        #: the bucket index on the device, by (length, device): one copy
        self._idx: dict = {}

    def position_bias(self, length: int) -> torch.Tensor:
        """The [1, H, L, L] bias of the table."""
        cfg, dev = self.cfg, self.rel_bias.device
        idx = self._idx.get((length, dev))
        if idx is None:
            idx = self._idx[length, dev] = torch.from_numpy(_buckets(
                length, cfg.rel_buckets, cfg.rel_max_distance)).to(dev)
        return self.rel_bias[idx].permute(2, 0, 1)[None]

    def forward(self, x, mask, pos_bias):
        cfg = self.cfg
        b, length, _ = x.shape

        def split(t):
            return t.view(b, length, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if self.rel_bias is not None:
            pos_bias = self.position_bias(length)
        scores = q @ k.transpose(-1, -2) + pos_bias
        if mask is not None:
            scores = scores.masked_fill(mask[:, None, None, :] <= 0, -1e9)
        att = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = (att @ v).transpose(1, 2).reshape(b, length, -1)
        return self.o(out), pos_bias


class T5Block(nn.Module):
    """Pre-norm self-attention, then the pre-norm feed-forward: gated GELU
    (tanh form, HF's ``NewGELUActivation``) or ReLU."""

    def __init__(self, cfg: T5Config, has_bias: bool = False):
        super().__init__()
        self.gated = cfg.feed_forward == "gated-gelu"
        self.attn_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        self.attn = T5Attention(cfg, has_bias)
        self.ff_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x, mask, pos_bias):
        att, pos_bias = self.attn(self.attn_ln(x), mask, pos_bias)
        x = x + att
        h = self.ff_ln(x)
        if self.gated:
            h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        else:
            h = F.relu(self.wi(h))
        return x + self.wo(h), pos_bias


class T5Encoder(nn.Module):
    """tokens [B, L] (and the attention mask [B, L]) → last_hidden_state
    [B, L, d_model]."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", T5Block(cfg, has_bias=i == 0))
        self.final_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, tokens: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.embed(tokens)
        pos_bias = None
        for i in range(self.cfg.num_layers):
            x, pos_bias = getattr(self, f"block_{i}")(x, attention_mask,
                                                      pos_bias)
        return self.final_ln(x)


class T5Conditioner:
    """``FrozenT5Embedder`` / ``FrozenFLANEmbedder``: texts → ids padded to
    ``max_length`` (a pluggable tokenizer, then EOS) → last_hidden_state
    on the conditioner's device. ``params``: a JAX or ``import_ckpt`` tree
    (numpy leaves) or ``None`` for a seeded random init. ``device=None`` is
    the card, and raises without one."""

    def __init__(self, cfg: T5Config | None = None,
                 params: Mapping | None = None,
                 tokenizer: Callable[[str], Sequence[int]] | None = None,
                 max_length: int = 77, pad_id: int = 0, eos_id: int = 1,
                 device: str | torch.device | None = None):
        self.cfg = cfg or T5Config()
        self.device = resolve_device(device)
        self.model = on_device(seeded(0, lambda: T5Encoder(self.cfg)),
                               self.device, params)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.pad_id, self.eos_id = pad_id, eos_id

    def tokenize(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """→ (ids, mask), int32 [B, max_length]: each text's first
        ``max_length − 1`` tokens, then EOS, then ``pad_id``."""
        if self.tokenizer is None:
            raise RuntimeError(
                "no tokenizer attached — the T5 SentencePiece model ships "
                "with the checkpoint; pass tokenizer=callable(text)->ids")
        ids = np.full((len(texts), self.max_length), self.pad_id, np.int32)
        mask = np.zeros_like(ids)
        for i, t in enumerate(texts):
            toks = list(self.tokenizer(t))[: self.max_length - 1] + \
                [self.eos_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        ids, mask = self.tokenize(texts)
        ids, mask = (torch.from_numpy(a).to(self.device, non_blocking=True)
                     for a in (ids.astype(np.int64), mask))
        return self.model(ids, mask)
