"""Audio captioner: Cnn14 + bidirectional GRU encoder → post-LN transformer
decoder (the agent's "Generate Text From The Audio" tool).

Counterpart of ``audiogpt_tpu/models/caption/captioner.py:27-242``. The
decoder layer follows ``torch.nn.TransformerDecoderLayer`` (self-attention
→ add + LN → cross-attention → add + LN → ReLU FFN → add + LN). Both decodes
re-run the decoder on the whole token row at each position, as the JAX
``fori_loop`` does (captions are at most 22 tokens): greedy keeps its
``done → eos`` rule, beam search its beam fold into the batch, frozen beams
and length-normalised pick. The JAX package's jitted-program caches have
no counterpart. Every attention here is short or masked: the plain path of
``ops/attention.py``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config, Cnn14Encoder
from audiogpt_tpu_torch.ops.attention import attention
from audiogpt_tpu_torch.ops.rnn import GRU


@dataclasses.dataclass(frozen=True)
class CaptionConfig:
    cnn14: Cnn14Config = Cnn14Config()
    rnn_hidden: int = 512
    rnn_bidirectional: bool = True
    vocab_size: int = 4981          # audiocaps vocab
    emb_dim: int = 256
    nhead: int = 4
    nlayers: int = 2
    dim_feedforward: int = 1024
    max_caption_len: int = 22
    sos_id: int = 0
    eos_id: int = 9


class TorchMHA(nn.Module):
    """Multi-head attention with ``nn.MultiheadAttention``'s packed input
    projection, held as the JAX parameter ``in_proj_weight [d, 3d]`` (x @ w:
    torch's ``[3d, d]`` transposed) and ``in_proj_bias [3d]``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(dim, 3 * dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                mask: torch.Tensor | None = None,
                is_causal: bool = False) -> torch.Tensor:
        d = q_in.shape[-1]
        wq, wk, wv = self.in_proj_weight.split(d, dim=1)
        bq, bk, bv = self.in_proj_bias.split(d)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads,
                             d // self.heads)

        out = attention(split(q_in @ wq + bq), split(kv_in @ wk + bk),
                        split(kv_in @ wv + bv), mask=mask,
                        is_causal=is_causal)
        return self.out_proj(out.reshape(q_in.shape))


class TorchDecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = TorchMHA(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.multihead_attn = TorchMHA(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                mem_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, x, is_causal=True))
        x = self.norm2(x + self.multihead_attn(x, memory, mask=mem_mask))
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


def sinusoid_pos(length: int, dim: int) -> np.ndarray:
    """Interleaved sin/cos (the captioner's PositionalEncoding)."""
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class CaptionModel(nn.Module):
    def __init__(self, cfg: CaptionConfig):
        super().__init__()
        self.cfg = cfg
        self.cnn = Cnn14Encoder(cfg.cnn14)
        self.rnn = GRU(cfg.cnn14.channels[-1], cfg.rnn_hidden,
                       cfg.rnn_bidirectional)
        self.word_embedding = nn.Embedding(cfg.vocab_size, cfg.emb_dim)
        mem_dim = cfg.rnn_hidden * (1 + cfg.rnn_bidirectional)
        self.attn_proj_fc = nn.Linear(mem_dim, cfg.emb_dim)
        self.attn_proj_ln = nn.LayerNorm(cfg.emb_dim, eps=1e-5)
        for i in range(cfg.nlayers):
            self.add_module(f"dec_layer_{i}", TorchDecoderLayer(
                cfg.emb_dim, cfg.nhead, cfg.dim_feedforward))
        self.classifier = nn.Linear(cfg.emb_dim, cfg.vocab_size)
        # the positions of a caption, on the model's device (no host copy
        # at each decode step)
        self.register_buffer("pos", torch.from_numpy(sinusoid_pos(
            cfg.max_caption_len, cfg.emb_dim)), persistent=False)

    def encode(self, wav: torch.Tensor, wav_len: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """wav [B, T] → (memory [B, T', 2·rnn_hidden], lengths [B])."""
        enc = self.cnn(wav, wav_len)
        return self.rnn(enc["attn_emb"], enc["attn_emb_len"]), \
            enc["attn_emb_len"]

    def decode_logits(self, words: torch.Tensor, memory: torch.Tensor,
                      mem_len: torch.Tensor | None = None) -> torch.Tensor:
        """words [B, T] → logits [B, T, V] (teacher forcing, or the re-run
        decode)."""
        cfg = self.cfg
        mem = self.attn_proj_ln(F.relu(self.attn_proj_fc(memory)))
        mem_mask = None
        if mem_len is not None:
            mem_mask = (torch.arange(mem.shape[1], device=mem.device)[None]
                        < mem_len[:, None])[:, None, None, :]
        t = words.shape[1]
        pos = self.pos[:t] if t <= self.pos.shape[0] else torch.from_numpy(
            sinusoid_pos(t, cfg.emb_dim)).to(words.device)
        x = self.word_embedding(words) * math.sqrt(cfg.emb_dim) + pos
        for i in range(cfg.nlayers):
            x = getattr(self, f"dec_layer_{i}")(x, mem, mem_mask)
        return self.classifier(x)

    def forward(self, wav: torch.Tensor, words: torch.Tensor,
                wav_len: torch.Tensor | None = None) -> torch.Tensor:
        memory, mem_len = self.encode(wav, wav_len)
        return self.decode_logits(words, memory, mem_len)


def _lengths(wav: torch.Tensor, wav_len) -> torch.Tensor:
    if wav_len is None:
        return torch.full((wav.shape[0],), wav.shape[1], dtype=torch.long,
                          device=wav.device)
    return torch.as_tensor(wav_len, device=wav.device).long()


@torch.inference_mode()
def caption_greedy_decode(model: CaptionModel, wav: torch.Tensor,
                          wav_len=None) -> torch.Tensor:
    """Greedy caption ids [B, max_caption_len]: SOS, then at each position
    the argmax of the re-run decoder; a row that has emitted EOS keeps
    EOS."""
    return greedy_tokens(model, *model.encode(wav, _lengths(wav, wav_len)))


@torch.inference_mode()
def greedy_tokens(model: CaptionModel, memory: torch.Tensor,
                  mem_len: torch.Tensor) -> torch.Tensor:
    """The greedy decode of :func:`caption_greedy_decode` from the
    encoder's memory [B, T', 2·rnn_hidden] and lengths [B]."""
    cfg = model.cfg
    b, dev = memory.shape[0], memory.device
    tokens = torch.full((b, cfg.max_caption_len), cfg.eos_id,
                        dtype=torch.long, device=dev)
    tokens[:, 0] = cfg.sos_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(1, cfg.max_caption_len):
        logits = model.decode_logits(tokens, memory, mem_len)
        nxt = logits[:, i - 1].argmax(-1)
        nxt = torch.where(done, cfg.eos_id, nxt)
        done = done | (nxt == cfg.eos_id)
        tokens[:, i] = nxt
    return tokens


@torch.inference_mode()
def caption_beam_decode(model: CaptionModel, wav: torch.Tensor,
                        wav_len=None, beam_size: int = 3,
                        length_penalty: float = 1.0) -> torch.Tensor:
    """Beam search → the best hypothesis' ids [B, max_caption_len] (the
    reference's beam decode, ``audio_to_text/captioning/models/
    base_model.py``). The beams fold into the batch for the decoder re-run;
    scores add log-probs, a finished beam continues only with EOS at no
    cost; the pick is by score over length ** ``length_penalty``."""
    cfg = model.cfg
    L, k, V = cfg.max_caption_len, beam_size, cfg.vocab_size
    memory, mem_len = model.encode(wav, _lengths(wav, wav_len))
    b, dev = wav.shape[0], wav.device
    mem = memory.repeat_interleave(k, dim=0)
    mlen = mem_len.repeat_interleave(k, dim=0)
    tokens = torch.full((b, k, L), cfg.eos_id, dtype=torch.long, device=dev)
    tokens[:, :, 0] = cfg.sos_id
    # the first expansion comes from beam 0 alone
    scores = torch.tensor([0.0] + [-1e9] * (k - 1), device=dev).repeat(b, 1)
    done = torch.zeros(b, k, dtype=torch.bool, device=dev)
    frozen = torch.full((V,), -1e9, device=dev)
    frozen[cfg.eos_id] = 0.0
    for i in range(1, L):
        logits = model.decode_logits(tokens.reshape(b * k, L), mem, mlen)
        logp = torch.log_softmax(logits[:, i - 1].reshape(b, k, V), dim=-1)
        logp = torch.where(done[..., None], frozen, logp)
        cand = (scores[..., None] + logp).reshape(b, k * V)
        scores, top = cand.topk(k, dim=-1)
        src, nxt = top // V, top % V
        tokens = tokens.gather(1, src[..., None].expand(-1, -1, L)).clone()
        done = done.gather(1, src)
        tokens[:, :, i] = torch.where(done, cfg.eos_id, nxt)
        done = done | (nxt == cfg.eos_id)
    lengths = (tokens != cfg.eos_id).sum(-1).clamp_min(1)
    best = (scores / lengths.float() ** length_penalty).argmax(-1)
    return tokens[torch.arange(b, device=dev), best]
