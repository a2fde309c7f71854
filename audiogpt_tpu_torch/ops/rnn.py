"""GRU, with the JAX package's parameters and its padded-row semantics.

Counterpart of ``audiogpt_tpu/ops/rnn.py:17-62`` (the captioner's encoder
GRU and the TSD net's). The JAX ``lax.scan`` is no TPU kernel: each
direction here is one unidirectional ``nn.GRU`` (cuDNN on the card). The
gate order and formulas are torch's own (r, z, n; ``n = tanh(W_in·x +
b_in + r·(W_hn·h + b_hn))``), so the JAX ``{fwd,bwd}_{w,b}_{ih,hh}`` leaves
map on by a transpose (``utils/jax_params.py``).
"""

from __future__ import annotations

import torch
from torch import nn


class GRU(nn.Module):
    """x [B, T, D] → [B, T, H·(1 + bidirectional)]."""

    def __init__(self, input_size: int, hidden_size: int,
                 bidirectional: bool = False):
        super().__init__()
        self.bidirectional = bidirectional
        self.fwd = nn.GRU(input_size, hidden_size, batch_first=True)
        if bidirectional:
            self.bwd = nn.GRU(input_size, hidden_size, batch_first=True)

    def forward(self, x: torch.Tensor,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
        h = self.fwd(x)[0]
        if not self.bidirectional:
            return h
        if lengths is None:
            hb = self.bwd(x.flip(1))[0].flip(1)
        else:
            # as JAX: reverse the valid prefix of each row, keep the padding
            # at the tail, and run the backward GRU over the whole row (a
            # packed sequence would zero the padded positions instead)
            idx = torch.arange(x.shape[1], device=x.device)[None]
            lens = lengths.to(x.device)[:, None]
            rev = torch.where(idx < lens, lens - 1 - idx, idx)[..., None]
            hb_r = self.bwd(x.gather(1, rev.expand(-1, -1, x.shape[-1])))[0]
            hb = hb_r.gather(1, rev.expand(-1, -1, hb_r.shape[-1]))
        return torch.cat([h, hb], dim=-1)
