"""Text frontend: raw text → (words, phones, tokens) for TTS/SVS.

Copy of ``audiogpt_tpu/text/frontend.py``; ``EnglishFrontend`` is the
``en`` text processor of ``registry.py``, as in JAX.

Mirrors the reference pipeline ``BasePreprocessor.txt_to_ph``
(``data_gen/tts/base_preprocess.py:147``) + ``TxtProcessor.process``
(``txt_processors/en.py:44``): normalize → G2P per word → txt_struct with
boundary/sep phones → phone & word token ids.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass

from audiogpt_tpu_torch.registry import TEXT_PROCESSORS
from audiogpt_tpu_torch.text.en_g2p import EnG2P
from audiogpt_tpu_torch.text.encoder import TokenTextEncoder
from audiogpt_tpu_torch.text.norm_en import normalize_numbers

PUNCS = "!,.?;:"


@dataclass
class ProcessedText:
    text: str                   # normalized text
    words: list[str]
    phones: list[str]           # flat phones incl. word-boundary markers
    ph2word: list[int]          # 1-based word index per phone


def preprocess_text(text: str) -> str:
    """Reference normalization chain (txt_processors/en.py:47-62)."""
    text = normalize_numbers(text)
    text = "".join(
        ch for ch in unicodedata.normalize("NFD", text)
        if unicodedata.category(ch) != "Mn"
    )
    text = text.lower()
    text = re.sub("['\"()]+", "", text)
    text = re.sub("[-]+", " ", text)
    text = re.sub(f"[^ a-z{PUNCS}]", "", text)
    text = re.sub(f" ?([{PUNCS}]) ?", r"\1", text)
    text = re.sub(f"([{PUNCS}])+", r"\1", text)
    text = text.replace("i.e.", "that is").replace("etc.", "etc")
    text = re.sub(f"([{PUNCS}])", r" \1 ", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


@TEXT_PROCESSORS.register("en")
class EnglishFrontend:
    """``__call__(text)`` → :class:`ProcessedText`; ``encode`` → ids."""

    def __init__(self, phone_encoder: TokenTextEncoder | None = None,
                 cmudict_path: str | None = None,
                 add_eos_bos: bool = True):
        self.g2p = EnG2P(cmudict_path)
        self.phone_encoder = phone_encoder
        self.add_eos_bos = add_eos_bos

    def __call__(self, text: str) -> ProcessedText:
        norm = preprocess_text(text)
        words = norm.split(" ")
        phs = self.g2p(norm)
        struct: list[list] = [[w, []] for w in words]
        i_word = 0
        for p in phs:
            if p == " ":
                i_word += 1
            elif i_word < len(struct):
                struct[i_word][1].append(p)
        # word-boundary markers + optional sentence padding, as the
        # reference's postprocess does (base_text_processor / preprocessor)
        phones: list[str] = []
        ph2word: list[int] = []
        for wi, (w, wphs) in enumerate(struct, start=1):
            if not wphs:
                wphs = [w] if w in PUNCS else []
            for p in wphs:
                phones.append(p)
                ph2word.append(wi)
            phones.append("|")
            ph2word.append(wi)
        if phones and phones[-1] == "|":
            phones = phones[:-1]
            ph2word = ph2word[:-1]
        if self.add_eos_bos:
            phones = ["<BOS>"] + phones + ["<EOS>"]
            ph2word = [0] + ph2word + [ph2word[-1] + 1 if ph2word else 1]
        return ProcessedText(norm, words, phones, ph2word)

    def encode(self, text: str) -> list[int]:
        pt = self(text)
        if self.phone_encoder is None:
            raise ValueError("no phone encoder configured")
        return self.phone_encoder.encode(pt.phones)

    @staticmethod
    def build_phone_vocab(corpus_phones) -> TokenTextEncoder:
        vocab = sorted(set(corpus_phones))
        return TokenTextEncoder(vocab)
