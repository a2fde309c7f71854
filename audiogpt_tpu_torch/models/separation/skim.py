"""SkiM — skipping-memory LSTM speech separation (the reference Speech_SS
tool's ESPnet ``wsj0_2mix_skim_noncausal``, ``audio-chatgpt.py:1010``).

Counterpart of ``audiogpt_tpu/models/separation/skim.py:22-129``: a conv
encoder (lax SAME padding) → segments [B, S, K, N] → R × (a bidirectional
segment LSTM over K that starts from the carried (h, c) → a bidirectional
memory LSTM over S that refreshes them) → a ReLU mask head per source → the
flax ``ConvTranspose(padding="SAME")`` decoder. Each LSTM direction is one
``nn.LSTM`` (cuDNN on the card); the flax ``OptimizedLSTMCell``'s per-gate
denses pack into it (``utils/jax_params.py``). The carried state feeds the
forward direction only, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.ops.conv import FlaxConvTranspose1d


@dataclasses.dataclass(frozen=True)
class SkiMConfig:
    n_src: int = 2
    enc_dim: int = 128          # N
    enc_kernel: int = 16        # L (stride L/2)
    hidden: int = 128           # LSTM hidden (per direction)
    segment_size: int = 50      # K
    n_blocks: int = 4           # R (SegLSTM+MemLSTM rounds)
    sample_rate: int = 16000

    @property
    def stride(self) -> int:
        return self.enc_kernel // 2


class BiLSTM(nn.Module):
    """x [B, T, D], an optional initial state (h0, c0) [B, hidden] of the
    forward direction → ([B, T, 2·hidden], (h_T, c_T) of the forward
    direction)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.fwd = nn.LSTM(input_size, hidden, batch_first=True)
        self.bwd = nn.LSTM(input_size, hidden, batch_first=True)

    def forward(self, x: torch.Tensor, h0: torch.Tensor | None = None,
                c0: torch.Tensor | None = None):
        state = None if h0 is None else (h0[None].contiguous(),
                                         c0[None].contiguous())
        ys_f, (h_t, c_t) = self.fwd(x, state)
        ys_b = self.bwd(x.flip(1))[0].flip(1)
        return torch.cat([ys_f, ys_b], dim=-1), (h_t[0], c_t[0])


class SkiMBlock(nn.Module):
    def __init__(self, cfg: SkiMConfig):
        super().__init__()
        n, hid = cfg.enc_dim, cfg.hidden
        self.seg_lstm = BiLSTM(n, hid)
        self.seg_proj = nn.Linear(2 * hid, n)
        self.seg_norm = nn.LayerNorm(n, eps=1e-6)
        self.mem_lstm_h = BiLSTM(hid, hid)
        self.mem_lstm_c = BiLSTM(hid, hid)
        self.mem_proj_h = nn.Linear(2 * hid, hid)
        self.mem_proj_c = nn.Linear(2 * hid, hid)

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """x [B, S, K, N]; carried (h, c) [B, S, H] → (x', h', c')."""
        b, s, k, n = x.shape
        out, (h_t, c_t) = self.seg_lstm(x.reshape(b * s, k, n),
                                        h.reshape(b * s, -1),
                                        c.reshape(b * s, -1))
        x = x + self.seg_norm(self.seg_proj(out)).reshape(b, s, k, n)
        # the memory LSTM across segments refreshes the carried states;
        # segment s + 1 starts from segment s's
        h_new = self.mem_proj_h(self.mem_lstm_h(h_t.reshape(b, s, -1))[0])
        c_new = self.mem_proj_c(self.mem_lstm_c(c_t.reshape(b, s, -1))[0])
        return (x, F.pad(h_new, (0, 0, 1, 0))[:, :-1],
                F.pad(c_new, (0, 0, 1, 0))[:, :-1])


class SkiM(nn.Module):
    """mix [B, T] → separated [B, n_src, T], the contract of
    ``ConvTasNet``. ``valid_len`` is taken for that contract and not used:
    SkiM's norms are per segment."""

    def __init__(self, cfg: SkiMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = nn.Conv1d(1, cfg.enc_dim, cfg.enc_kernel,
                                 stride=cfg.stride)
        for r in range(cfg.n_blocks):
            self.add_module(f"block{r}", SkiMBlock(cfg))
        self.mask_head = nn.Linear(cfg.enc_dim, cfg.n_src * cfg.enc_dim)
        self.decoder = FlaxConvTranspose1d(cfg.enc_dim, 1, cfg.enc_kernel,
                                           cfg.stride)

    def forward(self, wav: torch.Tensor,
                valid_len: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        b, t = wav.shape
        s_, k_len = cfg.stride, cfg.enc_kernel
        # lax SAME padding of a strided conv: ceil(T / s) frames
        total = max((-(-t // s_) - 1) * s_ + k_len - t, 0)
        feats = F.relu(self.encoder(F.pad(wav, (total // 2,
                                                total - total // 2))[:, None]))
        feats = feats.transpose(1, 2)                       # [B, F, N]
        f, k = feats.shape[1], cfg.segment_size
        x = F.pad(feats, (0, 0, 0, (k - f % k) % k))
        s = x.shape[1] // k
        x = x.reshape(b, s, k, cfg.enc_dim)
        h = x.new_zeros(b, s, cfg.hidden)
        c = x.new_zeros(b, s, cfg.hidden)
        for r in range(cfg.n_blocks):
            x, h, c = getattr(self, f"block{r}")(x, h, c)
        x = x.reshape(b, s * k, cfg.enc_dim)[:, :f]
        masks = F.relu(self.mask_head(x)).reshape(b, f, cfg.n_src,
                                                  cfg.enc_dim)
        masked = (feats[:, :, None] * masks).permute(0, 2, 3, 1).reshape(
            b * cfg.n_src, cfg.enc_dim, f)                  # [B·S, N, F]
        out = self.decoder(masked)[:, 0, :t]
        out = F.pad(out, (0, t - out.shape[1]))
        return out.reshape(b, cfg.n_src, t)
