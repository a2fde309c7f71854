"""Byte-level BPE text codecs: the CLIP tokenizer and the GPT-2 / whisper
family.

Counterpart of ``audiogpt_tpu/text/bpe.py``, copied with its behaviour:

  * **CLIP style**: lowercased, CLIP word splitter, ``</w>`` end-of-word
    marker, vocab derived from the published merges list, which ships with
    the port (``text/data/bpe_simple_vocab_16e6.txt.gz``). It is also the
    ASR engine's out-of-box detokenizer.
  * **GPT-2 / whisper style**: case-preserving, GPT-2 word splitter,
    space-carrying byte pieces; loadable from ``vocab.json`` +
    ``merges.txt``, an HF ``tokenizer.json`` or a tiktoken ranks file.

Encoding is greedy lowest-rank bigram merging over byte-mapped unicode
symbols; ranks come from an explicit merges list when one exists, else from
token ids (tiktoken convention). Per-word results are cached.

The word splitters need the Unicode letter and number classes (``\\p{L}``,
``\\p{N}``), which the standard ``re`` module lacks: they are built once from
``unicodedata`` into explicit character classes.
"""

from __future__ import annotations

import base64
import functools
import gzip
import html
import json
import os
import re
import sys
import unicodedata
import warnings

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CLIP_BPE_PATH = os.path.join(_DATA_DIR, "bpe_simple_vocab_16e6.txt.gz")


def _ranges(chars: list[str]) -> str:
    """Sorted characters → the body of a character class of their runs."""
    out, i = [], 0
    while i < len(chars):
        j = i
        while j + 1 < len(chars) and ord(chars[j + 1]) == ord(chars[j]) + 1:
            j += 1
        lo, hi = ord(chars[i]), ord(chars[j])
        out.append(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}")
        i = j + 1
    return "".join(out)


@functools.lru_cache()
def _letter_number_classes() -> tuple[str, str]:
    """Class bodies of every letter (category L*) and number (N*). Letters
    and numbers are word characters to ``re``, so only those are looked up."""
    every = "".join(map(chr, range(sys.maxunicode + 1)))
    letters, numbers = [], []
    for run in re.findall(r"\w+", every):
        for c in run:
            cat = unicodedata.category(c)[0]
            if cat == "L":
                letters.append(c)
            elif cat == "N":
                numbers.append(c)
    return _ranges(letters), _ranges(numbers)


@functools.lru_cache()
def _word_patterns() -> tuple[re.Pattern, re.Pattern]:
    """(CLIP's splitter, GPT-2's splitter).

    CLIP (open_clap/tokenizer.py:89): contractions, letter runs, single
    digits, punctuation runs; case-insensitive. GPT-2: like CLIP's but
    case-preserving, digit runs, and each piece carries its leading space."""
    letter, number = _letter_number_classes()
    clip = re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d|[{letter}]+|[{number}]"
        rf"|[^\s{letter}{number}]+", re.IGNORECASE)
    gpt2 = re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letter}]+| ?[{number}]+"
        rf"| ?[^\s{letter}{number}]+|\s+(?!\S)|\s+")
    return clip, gpt2


@functools.lru_cache()
def byte_unicode_table() -> dict[int, str]:
    """The published GPT-2 byte↔unicode table every byte-level BPE vocab is
    keyed on: visible latin-1 bytes map to themselves, the remaining 68
    bytes to U+0100.. in increasing byte order."""
    visible = set(range(0x21, 0x7F)) | set(range(0xA1, 0xAD)) \
        | set(range(0xAE, 0x100))
    table: dict[int, str] = {}
    n = 0
    for b in range(256):
        if b in visible:
            table[b] = chr(b)
        else:
            table[b] = chr(0x100 + n)
            n += 1
    return table


def _clip_clean(text: str) -> str:
    """CLIP's text cleanup minus ftfy mojibake repair (for well-formed
    unicode the two are identical)."""
    text = html.unescape(html.unescape(text)).strip()
    return re.sub(r"\s+", " ", text).strip()


class ByteBPE:
    """Byte-level BPE codec.

    Args:
      encoder: token string → id (token strings in byte-mapped unicode).
      merges: explicit merge list in priority order, or None to rank pairs
        by the merged token's id (tiktoken/whisper convention).
      end_of_word: suffix marking word ends ('</w>' for CLIP, '' for GPT-2).
      lowercase: CLIP lowercases + collapses whitespace before splitting.
      specials: special token string → id (kept out of the BPE vocab; split
        out of the input verbatim before word splitting).
    """

    def __init__(self, encoder: dict[str, int],
                 merges: list[tuple[str, str]] | None = None,
                 end_of_word: str = "", lowercase: bool = False,
                 specials: dict[str, int] | None = None):
        self.encoder = dict(encoder)
        self.end_of_word = end_of_word
        self.lowercase = lowercase
        self.specials = dict(specials or {})
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.decoder.update({i: t for t, i in self.specials.items()})
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        if merges is not None:
            self._rank = dict(zip(merges, range(len(merges)))).get
        else:
            self._rank = lambda pair: self.encoder.get(pair[0] + pair[1])
        self._pat = _word_patterns()[0 if lowercase else 1]
        self._special_pat = re.compile(
            "(" + "|".join(re.escape(s) for s in sorted(
                self.specials, key=len, reverse=True)) + ")") \
            if self.specials else None
        self._cache: dict[str, list[int]] = {}

    @property
    def vocab_size(self) -> int:
        return max(list(self.encoder.values())
                   + list(self.specials.values())) + 1

    def _merge_word(self, word: str) -> list[str]:
        """One regex word (byte-mapped) → its BPE pieces."""
        symbols = list(word)
        if self.end_of_word:
            if not symbols:
                return []
            symbols[-1] += self.end_of_word
        while len(symbols) > 1:
            best = None  # (rank, index)
            for i in range(len(symbols) - 1):
                r = self._rank((symbols[i], symbols[i + 1]))
                if r is not None and (best is None or r < best[0]):
                    best = (r, i)
            if best is None:
                break
            a, b = symbols[best[1]], symbols[best[1] + 1]
            out, i = [], 0
            while i < len(symbols):
                if i < len(symbols) - 1 and symbols[i] == a \
                        and symbols[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out
        return symbols

    def _encode_word(self, token: str) -> list[int]:
        ids = self._cache.get(token)
        if ids is None:
            mapped = "".join(self.byte_encoder[b]
                             for b in token.encode("utf-8"))
            unk = self.encoder.get("<unk>")
            ids = [self.encoder.get(p, unk) for p in self._merge_word(mapped)]
            ids = self._cache[token] = [i for i in ids if i is not None]
        return ids

    def encode(self, text: str) -> list[int]:
        """text → token ids (no SOT/EOT framing — callers own framing)."""
        if self.lowercase:
            text = _clip_clean(text).lower()
        chunks = self._special_pat.split(text) if self._special_pat else [text]
        ids: list[int] = []
        for chunk in chunks:
            if chunk in self.specials:
                ids.append(self.specials[chunk])
                continue
            for token in self._pat.findall(chunk):
                ids.extend(self._encode_word(token))
        return ids

    __call__ = encode

    def decode(self, ids, skip_special: bool = True) -> str:
        special_ids = set(self.specials.values())
        parts: list[str] = []
        for i in ids:
            i = int(i)
            if i in special_ids:
                if not skip_special:
                    parts.append(self.decoder[i])
                continue
            t = self.decoder.get(i)
            if t is not None:
                parts.append(t)
        text = "".join(parts)
        raw = bytes(self.byte_decoder[c] for c in text
                    if c in self.byte_decoder)
        out = raw.decode("utf-8", errors="replace")
        if self.end_of_word:  # '</w>' chars are plain ASCII: replace post-decode
            return out.replace(self.end_of_word, " ").strip()
        return out


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def load_clip_bpe(path: str | None = None) -> ByteBPE:
    """The CLIP tokenizer from its published merges data (bundled). Vocab
    layout (open_clap/tokenizer.py:72-84): 256 byte units, 256 ``X</w>``
    units, 48894 merges, then ``<start_of_text>``/``<end_of_text>`` →
    49408 ids."""
    path = path or CLIP_BPE_PATH
    lines = gzip.open(path).read().decode("utf-8").split("\n")
    merges = [tuple(line.split()) for line in lines[1:48894 + 1]]
    # published unit order: visible bytes (in range order) first, then the
    # 68 remapped bytes as U+0100.. — NOT increasing byte order
    table = byte_unicode_table()
    visible = [table[b] for b in (*range(0x21, 0x7F), *range(0xA1, 0xAD),
                                  *range(0xAE, 0x100))]
    units = visible + [chr(0x100 + n) for n in range(256 - len(visible))]
    vocab = units + [u + "</w>" for u in units] + ["".join(m) for m in merges]
    encoder = {t: i for i, t in enumerate(vocab)}
    specials = {"<start_of_text>": len(vocab), "<end_of_text>": len(vocab) + 1}
    return ByteBPE(encoder, merges, end_of_word="</w>", lowercase=True,
                   specials=specials)


class ClipTokenizer:
    """CLIP framing on top of :func:`load_clip_bpe`
    (``audiogpt_tpu/text/bpe.py:225-250``): ``__call__`` gives bare ids for
    engines that add their own SOT/EOT (``engines/t2i.py``), :meth:`framed`
    the zero-padded [n, context] layout."""

    def __init__(self, path: str | None = None):
        self.bpe = load_clip_bpe(path)
        self.sot = self.bpe.specials["<start_of_text>"]
        self.eot = self.bpe.specials["<end_of_text>"]

    def __call__(self, text: str) -> list[int]:
        return self.bpe.encode(text)

    def framed(self, texts: list[str], context_length: int = 77) -> np.ndarray:
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = ([self.sot] + self.bpe.encode(t)[: context_length - 2]
                   + [self.eot])
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        return self.bpe.decode(ids)


def load_gpt2_bpe(vocab_json: str, merges_txt: str | None = None,
                  added_tokens: dict[str, int] | None = None) -> ByteBPE:
    """GPT-2-family codec from ``vocab.json`` (+ optional ``merges.txt``
    whose first line is a ``#version`` header). Without a merges file,
    pair rank falls back to merged-token id order."""
    with open(vocab_json, encoding="utf-8") as f:
        encoder = json.load(f)
    merges = None
    if merges_txt and os.path.exists(merges_txt):
        with open(merges_txt, encoding="utf-8") as f:
            lines = [l.rstrip("\n") for l in f]
        # HF semantics: only the FIRST line is a header ('#version: ...').
        # '#'-prefixed lines elsewhere are real merges ('# #' -> '##').
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges = [tuple(l.split()) for l in lines if len(l.split()) == 2]
    specials = dict(added_tokens or {})
    for tok in ("<|endoftext|>", "<|startoftranscript|>"):
        if tok in encoder:
            specials[tok] = encoder.pop(tok)
    return ByteBPE(encoder, merges, specials=specials)


def load_hf_tokenizer_json(path: str) -> ByteBPE:
    """Codec from an HF ``tokenizer.json`` (``model.vocab`` +
    ``model.merges`` + ``added_tokens``)."""
    with open(path, encoding="utf-8") as f:
        blob = json.load(f)
    model = blob.get("model", {})
    encoder = dict(model.get("vocab", {}))
    raw = model.get("merges", [])
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
              for m in raw] or None
    specials = {t["content"]: t["id"] for t in blob.get("added_tokens", [])}
    for tok in list(specials):
        encoder.pop(tok, None)
    return ByteBPE(encoder, merges, specials=specials)


def load_tiktoken_bpe(path: str,
                      specials: dict[str, int] | None = None) -> ByteBPE:
    """Codec from a tiktoken ranks file (``base64(token_bytes) rank`` per
    line — the format openai-whisper ships its vocabs in). Merge priority =
    merged token id."""
    table = byte_unicode_table()
    encoder: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            b64, rank = line.split()
            tok = base64.b64decode(b64)
            encoder["".join(table[b] for b in tok)] = int(rank)
    return ByteBPE(encoder, merges=None, specials=specials or {})


def load_bpe_dir(path: str) -> ByteBPE:
    """Auto-detect a GPT-2-family vocab under ``path`` (a ckpt/tokenizer
    dir or a single file): ``tokenizer.json`` → ``vocab.json``+
    ``merges.txt`` → ``*.tiktoken``."""
    if os.path.isfile(path):
        if path.endswith(".tiktoken"):
            return load_tiktoken_bpe(path)
        if path.endswith("tokenizer.json"):
            return load_hf_tokenizer_json(path)
        return load_gpt2_bpe(path)
    tj = os.path.join(path, "tokenizer.json")
    if os.path.exists(tj):
        return load_hf_tokenizer_json(tj)
    vj = os.path.join(path, "vocab.json")
    if os.path.exists(vj):
        added = None
        aj = os.path.join(path, "added_tokens.json")
        if os.path.exists(aj):
            with open(aj, encoding="utf-8") as f:
                added = json.load(f)
        return load_gpt2_bpe(vj, os.path.join(path, "merges.txt"), added)
    for name in sorted(os.listdir(path)):
        if name.endswith(".tiktoken"):
            return load_tiktoken_bpe(os.path.join(path, name))
    raise FileNotFoundError(
        f"no BPE vocab (tokenizer.json / vocab.json / *.tiktoken) in {path}")


class WhisperDetokenizer:
    """ids → text for whisper decodes: drops every id at/above the special
    region (EOT=50257 multilingual; timestamps, task and language tokens all
    live above it), byte-decodes the rest. Plugs into
    ``ASREngine.text_decoder``."""

    def __init__(self, codec: ByteBPE, eot: int = 50257):
        self.codec = codec
        self.eot = eot

    def __call__(self, ids) -> str:
        body = [int(i) for i in ids if int(i) < self.eot]
        return self.codec.decode(body).strip()


#: whisper's non-speech symbol set (openai-whisper ``tokenizer.py
#: non_speech_tokens``): bracket/quote/markup symbols and music notes whose
#: single-token encodings are suppressed during transcription.
NON_SPEECH_SYMBOLS = (
    list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
    + "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} "
      "♪♪ ♪♪♪".split()
)
_MISC_SYMBOLS = set("♩♪♫♬♭♮♯")


def non_speech_ids(codec) -> tuple[int, ...]:
    """Token ids to suppress during speech decoding, computed against the
    wired codec: for each symbol, the id of its single-token encoding (with
    and without a leading space); music-note symbols are suppressed even
    when multi-token (their first id)."""
    out: set[int] = set()
    for symbol in list(NON_SPEECH_SYMBOLS) + sorted(_MISC_SYMBOLS):
        for variant in (symbol, " " + symbol):
            try:
                ids = codec.encode(variant)
            except Exception:
                continue
            if len(ids) == 1 or symbol in _MISC_SYMBOLS:
                if ids:
                    out.add(int(ids[0]))
    return tuple(sorted(out))


def warn_fallback(component: str, detail: str) -> None:
    """Loud, once-per-component warning for linguistically-void fallback
    tokenizers."""
    warnings.warn(
        f"[{component}] {detail} — text input is NOT being interpreted "
        f"linguistically. Provide a vocab (a whisper tokenizer dir or file) "
        f"for real behavior.", stacklevel=3)
