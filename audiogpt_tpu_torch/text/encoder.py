"""Token ↔ id vocabulary encoder.

Copy of ``audiogpt_tpu/text/encoder.py`` (the port imports nothing of the
JAX package). Same contract as the reference's ``TokenTextEncoder``
(``NeuralSeq/utils/text_encoder.py:157``): reserved ids ``<pad>=0``,
``<EOS>=1``, ``<UNK>=2``; space-separated token strings; JSON vocab files
(the binarizer's ``phone_set.json`` format — a plain list of tokens).
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

PAD, EOS, UNK, SEG = "<pad>", "<EOS>", "<UNK>", "|"
RESERVED = [PAD, EOS, UNK]
PAD_ID, EOS_ID, UNK_ID = 0, 1, 2


class TokenTextEncoder:
    def __init__(self, vocab_list: Sequence[str], replace_oov: str | None = UNK):
        """``vocab_list`` excludes reserved tokens (they're prepended),
        matching reference init-from-list semantics."""
        tokens = list(RESERVED) + [t for t in vocab_list if t not in RESERVED]
        self._id_to_token = dict(enumerate(tokens))
        self._token_to_id = {t: i for i, t in self._id_to_token.items()}
        self._replace_oov = replace_oov
        self.pad_index = PAD_ID
        self.eos_index = EOS_ID
        self.unk_index = UNK_ID
        self.seg_index = self._token_to_id.get(SEG, EOS_ID)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "TokenTextEncoder":
        with open(path) as f:
            data = json.load(f)
        # phone_set.json is a flat list that may or may not carry reserved ids
        data = [t for t in data if t not in RESERVED]
        return cls(data)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([self._id_to_token[i] for i in range(len(self))], f)

    # -- core ----------------------------------------------------------------
    def encode(self, s: str | Iterable[str]) -> list[int]:
        tokens = s.strip().split() if isinstance(s, str) else list(s)
        if self._replace_oov is not None:
            tokens = [t if t in self._token_to_id else self._replace_oov for t in tokens]
        return [self._token_to_id[t] for t in tokens]

    def decode(self, ids: Iterable[int], strip_eos=False, strip_padding=False) -> str:
        ids = list(ids)
        if strip_padding and PAD_ID in ids:
            ids = ids[: ids.index(PAD_ID)]
        if strip_eos and EOS_ID in ids:
            ids = ids[: ids.index(EOS_ID)]
        return " ".join(self._id_to_token.get(i, f"ID_{i}") for i in ids)

    def __len__(self) -> int:
        return len(self._id_to_token)

    def __contains__(self, token: str) -> bool:
        return token in self._token_to_id

    def pad(self) -> int:
        return PAD_ID

    def eos(self) -> int:
        return EOS_ID

    def unk(self) -> int:
        return UNK_ID
