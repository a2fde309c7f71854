"""Pure-Python SentencePiece **unigram** codec: the tokenizer of the T5 /
FLAN-T5 text tower (``models/textenc/t5.py``).

Counterpart of ``audiogpt_tpu/text/sentencepiece.py``, the port's own copy
(no sentencepiece wheel is needed). The reference's ``FrozenT5Embedder``
(``ldm/modules/encoders/modules.py:143``) tokenizes through HF's
``T5Tokenizer``, which wraps the sentencepiece library over the
``spiece.model`` shipped with every T5 checkpoint. This module reads the
``.model`` protobuf directly (a minimal wire-format walk: pieces are field
1 of ModelProto, ``{piece: string=1, score: float=2, type: enum=3}``) and
segments with the standard unigram Viterbi (the largest sum of piece
log-probabilities).

Semantics of the sentencepiece defaults that T5 uses:
  * Metaspace pretokenization: ``add_dummy_prefix`` prepends one space,
    then every space becomes ``▁`` (U+2581);
  * unknown characters take ``unk_id`` at ``min_score - unk_penalty`` (the
    library's ``kUnkPenalty = 10``), so known pieces always win where they
    apply, and a run of unknown characters is one unknown token;
  * decode joins the pieces and maps ``▁`` back to spaces.

The tie-breaks are JAX's: a later segmentation replaces an earlier one
only on a strictly larger score.
"""

from __future__ import annotations

import struct

META = "▁"  # ▁
_UNK_PENALTY = 10.0

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _walk_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's fields.
    Length-delimited values come as bytes, varints as int, 32/64-bit as
    raw bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 1:
            val, i = buf[i:i + 8], i + 8
        elif wt == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wt == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def parse_sp_model(data: bytes) -> list[tuple[str, float, int]]:
    """.model bytes → [(piece, score, type)] in id order."""
    pieces = []
    for field, wt, val in _walk_fields(data):
        if field == 1 and wt == 2:           # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _walk_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
    return pieces


def write_sp_model(pieces: list[tuple[str, float, int]]) -> bytes:
    """[(piece, score, type)] → serialized ModelProto bytes (the inverse of
    :func:`parse_sp_model`; fixtures + exporting hand-built vocabs)."""
    def varint(v: int) -> bytes:
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    blob = bytearray()
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        body = (bytes([0x0A]) + varint(len(pb)) + pb          # field 1, wt 2
                + bytes([0x15]) + struct.pack("<f", score)    # field 2, wt 5
                + bytes([0x18]) + varint(ptype))              # field 3, wt 0
        blob += bytes([0x0A]) + varint(len(body)) + body      # ModelProto f1
    return bytes(blob)


class SentencePieceUnigram:
    """Loadable from a ``spiece.model`` path/bytes or an explicit
    ``[(piece, score, type)]`` list. ``__call__(text) -> ids`` plugs straight
    into ``T5Conditioner(tokenizer=...)`` (which appends EOS itself)."""

    def __init__(self, model, add_dummy_prefix: bool = True):
        if isinstance(model, (str, bytes)):
            if isinstance(model, str):
                with open(model, "rb") as f:
                    model = f.read()
            pieces = parse_sp_model(model)
        else:
            pieces = [(x[0], float(x[1]), (x[2] if len(x) > 2 else NORMAL))
                      for x in model]
        self.pieces = [p for p, _, _ in pieces]
        self.scores = [s for _, s, _ in pieces]
        self.types = [t for _, _, t in pieces]
        self.index = {p: i for i, (p, _, t) in enumerate(pieces)
                      if t in (NORMAL, USER_DEFINED)}
        self.unk_id = next((i for i, t in enumerate(self.types)
                            if t == UNKNOWN), 0)
        self.add_dummy_prefix = add_dummy_prefix
        scorable = [s for s, t in zip(self.scores, self.types)
                    if t in (NORMAL, USER_DEFINED)]
        self._unk_score = (min(scorable) if scorable else 0.0) - _UNK_PENALTY
        self._max_piece = max((len(p) for p in self.index), default=1)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # -- encode -------------------------------------------------------------
    def _viterbi(self, s: str) -> list[int]:
        """Best segmentation of one pre-tokenized chunk (maximize summed
        scores; unknown single chars take unk_id at min_score - 10)."""
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            hi = min(n, i + self._max_piece)
            for j in range(i + 1, hi + 1):
                pid = self.index.get(s[i:j])
                if pid is not None:
                    sc = best[i] + self.scores[pid]
                    if sc > best[j]:
                        best[j], back[j] = sc, (i, pid)
            # unk fallback: single char
            sc = best[i] + self._unk_score
            if sc > best[i + 1]:
                best[i + 1], back[i + 1] = sc, (i, self.unk_id)
        ids: list[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            # sentencepiece fuses consecutive unknown chars into ONE unk
            # token (HF tokenizers.Unigram agrees); without this an OOV run
            # emits one unk per char and diverges from the T5Tokenizer.
            if not (pid == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(pid)
            j = i
        return ids[::-1]

    def encode(self, text: str) -> list[int]:
        if not text:
            return []
        if self.add_dummy_prefix:
            text = " " + text
        return self._viterbi(text.replace(" ", META))

    __call__ = encode

    def encode_pieces(self, text: str) -> list[str]:
        return [self.pieces[i] for i in self.encode(text)]

    # -- decode -------------------------------------------------------------
    def decode(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            if 0 <= i < len(self.pieces) and self.types[i] in (NORMAL,
                                                               USER_DEFINED):
                out.append(self.pieces[i])
            elif i == self.unk_id:
                out.append(" ⁇ ")      # sentencepiece's unk surface
        return "".join(out).replace(META, " ").strip()
