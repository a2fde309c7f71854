"""CLAP text-side conditioning and the WordPiece tokenizer.

Counterpart of ``audiogpt_tpu/models/textenc/clap.py:22-193``:
``FrozenCLAPEmbedder`` (``ldm/modules/encoders/modules.py:173``) is the
bert-base-uncased last hidden state through a per-token ``Projection``
(768 → 1024, ``CLAP/clap.py:8``); the T2A UNet cross-attends to that
sequence ([B, 77, 1024]). The tokenizer is this package's own copy, with its
own copy of the bundled vocab. The audio tower and the best-of-n scorer come
with a later slice.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import re
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.textenc.bert import BertConfig, BertEncoder


@dataclasses.dataclass(frozen=True)
class CLAPTextConfig:
    bert: BertConfig = BertConfig()
    d_proj: int = 1024
    max_length: int = 77


class Projection(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.linear1 = nn.Linear(d_in, d_out, bias=False)
        self.linear2 = nn.Linear(d_out, d_out, bias=False)
        self.ln = nn.LayerNorm(d_out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.linear1(x)
        return self.ln(e1 + self.linear2(F.gelu(e1)))


class CLAPTextEncoder(nn.Module):
    def __init__(self, cfg: CLAPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.base = BertEncoder(cfg.bert)
        self.projection = Projection(cfg.bert.hidden_size, cfg.d_proj)

    def forward(self, tokens: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """→ per-token context [B, L, d_proj] (the LDM conditioning)."""
        return self.projection(self.base(tokens, attention_mask))

    def cls_embedding(self, tokens: torch.Tensor,
                      attention_mask: torch.Tensor | None = None
                      ) -> torch.Tensor:
        """→ [B, d_proj] CLS projection (CLAP similarity space)."""
        return self.projection(self.base(tokens, attention_mask)[:, 0])


# ---------------------------------------------------------------------------
# Minimal WordPiece tokenizer (BERT-uncased scheme, vocab from file)
# ---------------------------------------------------------------------------


def bundled_wordpiece_path() -> str | None:
    """Path of the bundled derived WordPiece vocab, or None if absent."""
    p = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "text", "data", "wordpiece_en.txt.gz")
    return p if os.path.exists(p) else None


def _open_vocab(path: str):
    """Iterate vocab lines from a plain or gzipped vocab.txt."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            yield from f
    else:
        with open(path, encoding="utf-8") as f:
            yield from f


class WordPieceTokenizer:
    """Loads a BERT ``vocab.txt`` (plain or ``.gz``).

    Without an explicit path, the bundled derived English vocab
    (``text/data/wordpiece_en.txt.gz``: 30,522 entries; special ids match
    bert-base-uncased: [PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102) loads when
    it fits the model's embedding table. Only when no vocab fits (tiny test
    configs) does it fall back to hash-bucket ids, with a warning."""

    CLS, SEP, PAD, UNK = "[CLS]", "[SEP]", "[PAD]", "[UNK]"

    def __init__(self, vocab_path: str | None = None, vocab_size: int = 30522):
        self.vocab: dict[str, int] = {}
        self.vocab_size = vocab_size
        self._warned = False
        if vocab_path is None:
            bundled = bundled_wordpiece_path()
            if bundled is not None:
                n = sum(1 for _ in _open_vocab(bundled))
                if n <= vocab_size:  # must fit the embedding table
                    vocab_path = bundled
        if vocab_path:
            for i, line in enumerate(_open_vocab(vocab_path)):
                self.vocab[line.rstrip("\n")] = i
            self.vocab_size = len(self.vocab)

    def _warn_no_vocab(self):
        if not self._warned:
            self._warned = True
            warnings.warn("WordPieceTokenizer: no vocab.txt loaded: "
                          "hash-bucket token ids", stacklevel=3)

    def _wordpiece(self, word: str) -> list[str]:
        if word in self.vocab:
            return [word]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.UNK]
            out.append(cur)
            start = end
        return out

    def encode(self, text: str,
               max_length: int = 77) -> tuple[np.ndarray, np.ndarray]:
        """→ (ids [max_length], attention_mask [max_length]), int32."""
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        if self.vocab:
            toks = [self.vocab.get(self.CLS, 101)]
            for w in words:
                toks += [self.vocab.get(t, self.vocab.get(self.UNK, 100))
                         for t in self._wordpiece(w)]
            toks.append(self.vocab.get(self.SEP, 102))
        else:
            self._warn_no_vocab()
            lo = min(1000, self.vocab_size // 4)
            span = max(1, self.vocab_size - lo - 3)
            toks = [101 % self.vocab_size] + [
                lo + hash(w) % span for w in words] + [102 % self.vocab_size]
        toks = toks[:max_length]
        mask = [1] * len(toks)
        pad = max_length - len(toks)
        return (np.asarray(toks + [0] * pad, np.int32),
                np.asarray(mask + [0] * pad, np.int32))
