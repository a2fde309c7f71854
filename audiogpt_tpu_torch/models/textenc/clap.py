"""CLAP text-side conditioning and the WordPiece tokenizer.

Counterpart of ``audiogpt_tpu/models/textenc/clap.py:22-193``:
``FrozenCLAPEmbedder`` (``ldm/modules/encoders/modules.py:173``) is the
bert-base-uncased last hidden state through a per-token ``Projection``
(768 → 1024, ``CLAP/clap.py:8``); the T2A UNet cross-attends to that
sequence ([B, 77, 1024]). The tokenizer is this package's own copy, with its
own copy of the bundled vocab. :class:`CLAPScorer` (``clap.py:201-301``)
ranks best-of-n candidates with the CLS projection against one of the two
audio towers: PANN (Cnn14) or HTSAT (``models/textenc/htsat.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import os
import re
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config, Cnn14Encoder
from audiogpt_tpu_torch.models.textenc.bert import BertConfig, BertEncoder
from audiogpt_tpu_torch.models.textenc.htsat import (
    HTSATAudioEncoder,
    HTSATConfig,
)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


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

    def decode(self, ids) -> str:
        """ids → text: specials skipped, ``##`` pieces merged (BERT
        ``convert_tokens_to_string``), as the JAX tokenizer decodes; without
        a vocab, ``<id>`` placeholders."""
        if not self.vocab:
            self._warn_no_vocab()
            return " ".join(f"<{int(i)}>" for i in ids)
        inv = getattr(self, "_inv", None)
        if inv is None:
            inv = self._inv = {v: k for k, v in self.vocab.items()}
        words: list[str] = []
        special = {self.CLS, self.SEP, self.PAD, "[MASK]"}
        for i in ids:
            t = inv.get(int(i), self.UNK)
            if t in special or t.startswith("[unused"):
                continue
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)


# ---------------------------------------------------------------------------
# CLAP audio tower + retrieval scorer (best-of-n re-ranking)
# ---------------------------------------------------------------------------


class CLAPAudioEncoder(nn.Module):
    """PANN (Cnn14) CLAP audio tower (``open_clap/pann_model.py``): the
    Cnn14 ``fc_emb`` through a ``Projection`` → ``[B, d_proj]``."""

    def __init__(self, d_proj: int = 1024, cnn14: Cnn14Config | None = None):
        super().__init__()
        if cnn14 is not None and not isinstance(cnn14, Cnn14Config):
            raise TypeError(f"CLAPAudioEncoder.cnn14 must be a Cnn14Config "
                            f"(got {type(cnn14).__name__})")
        cfg = cnn14 if cnn14 is not None else Cnn14Config()
        self.backbone = Cnn14Encoder(cfg)
        self.projection = Projection(cfg.channels[-1], d_proj)

    def forward(self, wav: torch.Tensor,
                wav_len: torch.Tensor | None = None) -> torch.Tensor:
        return self.projection(self.backbone(wav, wav_len)["fc_emb"])


class CLAPScorer:
    """Text ↔ audio cosine similarity: the reference's ``CLAPWrapper``
    (``wav_evaluation/models/CLAPWrapper.py:208``), built once. Its own text
    tower (scored by the CLS projection) and tokenizer, and the PANN or the
    HTSAT audio tower."""

    def __init__(self, text_cfg: CLAPTextConfig | None = None,
                 text_params=None, audio_params=None,
                 tokenizer: WordPieceTokenizer | None = None,
                 sample_rate: int = 32000, audio_tower: str = "pann",
                 audio_cfg: Cnn14Config | HTSATConfig | None = None,
                 rng_seed: int = 0,
                 device: str | torch.device | None = None):
        """``audio_tower``: ``"pann"`` (Cnn14; ``audio_cfg`` a
        ``Cnn14Config``) or ``"htsat"`` (``audio_cfg`` an ``HTSATConfig``,
        by default HTSAT-tiny; its ``d_proj`` becomes the text tower's).
        ``text_params`` / ``audio_params``: the JAX scorer's flax trees as
        numpy arrays (the PANN tree with its ``batch_stats``); ``None``
        keeps a seeded random init. ``sample_rate`` is the candidates' rate,
        kept for callers: each tower applies its own frontend (PANN's
        32 kHz, HTSAT's 48 kHz) to any waveform, as the JAX towers do.
        ``device=None`` is the card, and raises without one."""
        # imported here: engines/ imports this module
        from audiogpt_tpu_torch.engines.base import resolve_device

        self.cfg = text_cfg or CLAPTextConfig()
        if audio_tower == "htsat":
            if audio_cfg is None:
                audio_cfg = HTSATConfig()
            elif not isinstance(audio_cfg, HTSATConfig):
                raise TypeError(f"audio_tower='htsat' takes an HTSATConfig "
                                f"audio_cfg (got {type(audio_cfg).__name__})")
            audio_cfg = dataclasses.replace(audio_cfg, d_proj=self.cfg.d_proj)
            tower = HTSATAudioEncoder
        elif audio_tower == "pann":
            if audio_cfg is not None and not isinstance(audio_cfg,
                                                        Cnn14Config):
                raise TypeError(f"audio_tower='pann' takes a Cnn14Config "
                                f"audio_cfg (got {type(audio_cfg).__name__})")
            tower = functools.partial(CLAPAudioEncoder, self.cfg.d_proj)
        else:
            raise ValueError(f"unknown CLAPScorer audio_tower "
                             f"{audio_tower!r}: 'pann' or 'htsat'")
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.text = CLAPTextEncoder(self.cfg)
            self.audio = tower(audio_cfg)
        for m in (self.text, self.audio):
            m.to(self.device).eval()
        self._replica_sets: dict[tuple, list] = {}
        self.load_jax_params(text_params, audio_params)
        self.tokenizer = tokenizer or WordPieceTokenizer(
            vocab_size=self.cfg.bert.vocab_size)
        self.sample_rate = sample_rate

    def load_jax_params(self, text_params=None, audio_params=None) -> None:
        """Load the JAX scorer's trees (numpy leaves) into the towers given
        one, strictly; the audio tower's replicas are copied again."""
        if text_params is not None:
            load_jax_params(self.text, text_params)
        if audio_params is not None:
            load_jax_params(self.audio, audio_params)
        self._weights_loaded()

    def _weights_loaded(self) -> None:
        # imported here: engines/ imports this module
        from audiogpt_tpu_torch.engines.base import device_views

        self._replica_sets = {mesh: device_views(self, mesh, ("audio",))
                              for mesh in self._replica_sets}

    def replicas(self, mesh) -> list["CLAPScorer"]:
        """The scorer on every entry of ``mesh`` (a ``parallel.device_mesh``
        whose first entry is the scorer's device), for a T2A engine whose
        candidates shard over it: the scorer itself, then views with their
        own copy of the audio tower on their device (the text tower runs
        once, on the first: :meth:`text_embedding`). Built at a mesh's
        first call and again at every weight load."""
        from audiogpt_tpu_torch.engines.base import device_views

        key = tuple(mesh)
        if key not in self._replica_sets:
            self._replica_sets[key] = device_views(self, key, ("audio",))
        return self._replica_sets[key]

    @torch.inference_mode()
    def text_embedding(self, text: str) -> torch.Tensor:
        """The text's CLS projection, unit norm → [1, d_proj] on the
        scorer's device."""
        # non_blocking: the candidates' work is still queued, and a blocking
        # host-to-device copy would wait for it before the towers are queued
        ids, mask = (torch.from_numpy(a).long()[None].to(self.device,
                                                         non_blocking=True)
                     for a in self.tokenizer.encode(text, self.cfg.max_length))
        t = self.text.cls_embedding(ids, mask)
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)

    @torch.inference_mode()
    def audio_similarity(self, t: torch.Tensor,
                         wavs: torch.Tensor) -> torch.Tensor:
        """wavs [n, T] and a unit text embedding ``t`` [1, d_proj], both on
        the scorer's device → cosine similarity [n] there, each
        candidate's length taken as T."""
        wav_len = torch.full((wavs.shape[0],), wavs.shape[1],
                             dtype=torch.int64, device=wavs.device)
        a = self.audio(wavs, wav_len)
        a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        return (a @ t.T)[:, 0]

    def similarity(self, text: str, wavs: torch.Tensor) -> torch.Tensor:
        """wavs [n, T] on the scorer's device → cosine similarity [n] there,
        each candidate's length taken as T."""
        return self.audio_similarity(self.text_embedding(text), wavs)

    def score(self, text: str, wavs) -> np.ndarray:
        """→ similarity per candidate waveform ([n, T] or [T], numpy)."""
        wavs = np.asarray(wavs, np.float32)
        if wavs.ndim == 1:
            wavs = wavs[None]
        return self.similarity(
            text, torch.from_numpy(wavs).to(self.device)).cpu().numpy()

    def select_best(self, text: str, wavs) -> int:
        return int(self.score(text, wavs).argmax())
