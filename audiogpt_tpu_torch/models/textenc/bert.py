"""BERT text encoder, post-LN, weight-compatible with HF ``BertModel``.

Counterpart of ``audiogpt_tpu/models/textenc/bert.py``: the conditioning
tower of CLAP (``ldm/modules/encoders/CLAP/clap.py:42``). Its attention
takes a dense mask, so it is always the plain product (``ops.attention``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.attn_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.inter = nn.Linear(d, cfg.intermediate_size)
        self.out = nn.Linear(cfg.intermediate_size, d)
        self.out_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape

        def split(t):
            return t.reshape(b, n, self.heads, d // self.heads)

        att = attention(split(self.q(x)), split(self.k(x)), split(self.v(x)),
                        mask=mask)
        x = self.attn_ln(x + self.attn_out(att.reshape(b, n, d)))
        return self.out_ln(x + self.out(F.gelu(self.inter(x))))


class BertEncoder(nn.Module):
    """tokens [B, L] (+ attention_mask) → last_hidden_state [B, L, H]."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.word_emb = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_emb = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.type_emb = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.emb_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg))

    def forward(self, tokens: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(tokens)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = (self.word_emb(tokens) + self.pos_emb(pos)
             + self.type_emb(token_type_ids))
        x = self.emb_ln(x)
        mask = attention_mask[:, None, None, :] > 0
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x
