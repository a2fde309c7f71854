"""Pinyin syllables → initial / final phones, for the SVS score path.

Copy of ``INITIALS`` and ``split_pinyin`` from
``audiogpt_tpu/text/zh.py:28-29,219-226``. The SVS engines take scores as
space-separated pinyin (or romanized) syllables and split them here; the
rest of the Chinese frontend (normalisation, the hanzi lexicon) belongs to
PortaSpeech and is not ported yet.
"""

from __future__ import annotations

INITIALS = ["zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g",
            "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w"]


def split_pinyin(syllable: str) -> list[str]:
    """'xiao3' → ['x', 'iao3']; 'ai4' → ['ai4'] (zero-initial)."""
    s = syllable.lower().strip()
    for ini in INITIALS:
        if s.startswith(ini) and len(s) > len(ini) and \
                not s[len(ini)].isdigit():
            return [ini, s[len(ini):]]
    return [s]
