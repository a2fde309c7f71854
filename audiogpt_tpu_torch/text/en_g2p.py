"""English grapheme→phoneme (ARPAbet).

Copy of ``audiogpt_tpu/text/en_g2p.py``; it needs only the standard ``re``.

Replaces the reference's ``EnG2p`` (``data_gen/tts/txt_processors/en.py:12``,
built on the g2p_en wheel + CMUdict, neither shipped in this image) with a
three-tier resolver:

  1. a user-provided CMUdict file (``load_cmudict``) — full fidelity when the
     user has the data (same dictionary g2p_en uses),
  2. a built-in exception lexicon of frequent irregular words,
  3. rule-based letter-to-sound (context-sensitive rewrite rules in the
     NRL/Elovitz tradition) for everything else.

Output phones use ARPAbet with stress digits on vowels (AH0, EY1, …), the
same inventory NeuralSeq phone sets use, so trained checkpoints line up.
"""

from __future__ import annotations

import re

# Frequent irregular words (tier 2). Pronunciations are standard CMUdict-style.
LEXICON: dict[str, list[str]] = {
    "a": ["AH0"], "an": ["AE1 N"], "the": ["DH AH0"], "of": ["AH1 V"],
    "to": ["T UW1"], "and": ["AE1 N D"], "in": ["IH0 N"], "is": ["IH1 Z"],
    "you": ["Y UW1"], "that": ["DH AE1 T"], "it": ["IH1 T"], "he": ["HH IY1"],
    "she": ["SH IY1"], "was": ["W AA1 Z"], "for": ["F AO1 R"], "are": ["AA1 R"],
    "as": ["AE1 Z"], "with": ["W IH1 DH"], "his": ["HH IH1 Z"], "they": ["DH EY1"],
    "i": ["AY1"], "be": ["B IY1"], "this": ["DH IH1 S"], "have": ["HH AE1 V"],
    "from": ["F R AH1 M"], "or": ["AO1 R"], "one": ["W AH1 N"], "had": ["HH AE1 D"],
    "by": ["B AY1"], "word": ["W ER1 D"], "but": ["B AH1 T"], "not": ["N AA1 T"],
    "what": ["W AH1 T"], "all": ["AO1 L"], "were": ["W ER1"], "we": ["W IY1"],
    "when": ["W EH1 N"], "your": ["Y AO1 R"], "can": ["K AE1 N"],
    "said": ["S EH1 D"], "there": ["DH EH1 R"], "use": ["Y UW1 S"],
    "each": ["IY1 CH"], "which": ["W IH1 CH"], "do": ["D UW1"],
    "how": ["HH AW1"], "their": ["DH EH1 R"], "if": ["IH1 F"],
    "will": ["W IH1 L"], "up": ["AH1 P"], "other": ["AH1 DH ER0"],
    "about": ["AH0 B AW1 T"], "out": ["AW1 T"], "many": ["M EH1 N IY0"],
    "then": ["DH EH1 N"], "them": ["DH EH1 M"], "these": ["DH IY1 Z"],
    "so": ["S OW1"], "some": ["S AH1 M"], "her": ["HH ER1"],
    "would": ["W UH1 D"], "make": ["M EY1 K"], "like": ["L AY1 K"],
    "him": ["HH IH1 M"], "into": ["IH0 N T UW1"], "time": ["T AY1 M"],
    "has": ["HH AE1 Z"], "look": ["L UH1 K"], "two": ["T UW1"],
    "more": ["M AO1 R"], "write": ["R AY1 T"], "go": ["G OW1"],
    "see": ["S IY1"], "no": ["N OW1"], "way": ["W EY1"],
    "could": ["K UH1 D"], "people": ["P IY1 P AH0 L"], "my": ["M AY1"],
    "than": ["DH AE1 N"], "first": ["F ER1 S T"], "water": ["W AO1 T ER0"],
    "been": ["B IH1 N"], "who": ["HH UW1"], "its": ["IH1 T S"],
    "now": ["N AW1"], "find": ["F AY1 N D"], "long": ["L AO1 NG"],
    "down": ["D AW1 N"], "day": ["D EY1"], "did": ["D IH1 D"],
    "get": ["G EH1 T"], "come": ["K AH1 M"], "made": ["M EY1 D"],
    "may": ["M EY1"], "part": ["P AA1 R T"], "audio": ["AO1 D IY0 OW0"],
    "music": ["M Y UW1 Z IH0 K"], "speech": ["S P IY1 CH"],
    "sound": ["S AW1 N D"], "voice": ["V OY1 S"], "sing": ["S IH1 NG"],
    "hello": ["HH AH0 L OW1"], "world": ["W ER1 L D"],
    "dog": ["D AO1 G"], "cat": ["K AE1 T"], "bird": ["B ER1 D"],
    "generate": ["JH EH1 N ER0 EY2 T"], "once": ["W AH1 N S"],
    "was'nt": ["W AA1 Z AH0 N T"], "very": ["V EH1 R IY0"],
    "here": ["HH IY1 R"], "does": ["D AH1 Z"], "done": ["D AH1 N"],
    "gone": ["G AO1 N"], "says": ["S EH1 Z"], "eye": ["AY1"],
    "heart": ["HH AA1 R T"], "give": ["G IH1 V"], "live": ["L IH1 V"],
    "love": ["L AH1 V"], "move": ["M UW1 V"], "above": ["AH0 B AH1 V"],
    "again": ["AH0 G EH1 N"], "any": ["EH1 N IY0"], "answer": ["AE1 N S ER0"],
    "beautiful": ["B Y UW1 T AH0 F AH0 L"], "because": ["B IH0 K AO1 Z"],
}

# Context-sensitive rewrite rules (tier 3), in the NRL/Elovitz tradition:
# (left-context, target, right-context, phones). '#'=one or more vowels,
# '^'=one consonant, '.'=voiced consonant (b d v g j l m n r w z),
# '%'=suffix (e|er|es|ed|ing|ely), '&'=sibilant, '@'=t/s/r-ish, ' '=word edge.
# First match wins; scanned in order at each position.
_RULES: list[tuple[str, str, str, str]] = [
    # -- multi-letter clusters first
    ("", "tion", "", "SH AH0 N"),
    ("", "sion", "", "ZH AH0 N"),
    ("", "ough", " ", "OW1"),
    ("", "augh", "", "AO1 F"),
    ("", "ought", "", "AO1 T"),
    ("", "igh", "", "AY1"),
    ("", "eigh", "", "EY1"),
    ("", "tch", "", "CH"),
    ("", "qu", "", "K W"),
    ("", "ph", "", "F"),
    ("", "sh", "", "SH"),
    (" ", "ch", "", "CH"),
    ("", "ch", "", "CH"),
    (" ", "th", " ", "DH"),
    ("", "th", "", "TH"),
    ("", "ck", "", "K"),
    (" ", "kn", "", "N"),
    (" ", "wr", "", "R"),
    (" ", "wh", "", "W"),
    ("", "ng", " ", "NG"),
    ("", "ng", "", "NG G"),
    ("", "dge", "", "JH"),
    ("", "gh", "", "G"),
    # -- vowel digraphs
    ("", "ee", "", "IY1"),
    ("", "ea", "", "IY1"),
    ("", "oo", "k", "UH1"),
    ("", "oo", "", "UW1"),
    ("", "ou", "s", "AW1"),
    ("", "ou", "", "AW1"),
    ("", "ow", " ", "OW1"),
    ("", "ow", "", "AW1"),
    ("", "oi", "", "OY1"),
    ("", "oy", "", "OY1"),
    ("", "ai", "", "EY1"),
    ("", "ay", "", "EY1"),
    ("", "au", "", "AO1"),
    ("", "aw", "", "AO1"),
    ("", "oa", "", "OW1"),
    ("", "ie", " ", "AY1"),
    ("", "ie", "", "IY1"),
    ("", "ei", "", "EY1"),
    ("", "ey", "", "IY1"),
    ("", "ue", "", "UW1"),
    ("", "ui", "", "UW1"),
    # -- r-colored vowels
    ("", "ar", "", "AA1 R"),
    ("", "or", "", "AO1 R"),
    ("", "er", " ", "ER0"),
    ("", "er", "", "ER1"),
    ("", "ir", "", "ER1"),
    ("", "ur", "", "ER1"),
    # -- magic-e long vowels: a_e i_e o_e u_e
    ("", "a", "^e ", "EY1"),
    ("", "i", "^e ", "AY1"),
    ("", "o", "^e ", "OW1"),
    ("", "u", "^e ", "UW1"),
    ("", "y", "^e ", "AY1"),
    # -- single vowels
    ("", "e", " ", ""),  # final silent e
    ("", "e", "d ", "EH1"),  # will often be silent; simplification
    ("", "a", "", "AE1"),
    ("", "e", "", "EH1"),
    ("", "i", "", "IH1"),
    ("", "o", "", "AA1"),
    ("", "u", "", "AH1"),
    (" ", "y", "", "Y"),
    ("", "y", " ", "IY0"),
    ("", "y", "", "IH1"),
    # -- consonants
    ("", "c", "e", "S"), ("", "c", "i", "S"), ("", "c", "y", "S"),
    ("", "c", "", "K"),
    ("", "g", "e ", "JH"), ("", "g", "i", "JH"), ("", "g", "y", "JH"),
    ("", "g", "", "G"),
    ("", "s", " ", "Z"),
    ("", "s", "", "S"),
    ("", "x", "", "K S"),
    ("", "j", "", "JH"),
    ("", "z", "", "Z"),
    ("", "b", "", "B"), ("", "d", "", "D"), ("", "f", "", "F"),
    ("", "h", "", "HH"), ("", "k", "", "K"), ("", "l", "", "L"),
    ("", "m", "", "M"), ("", "n", "", "N"), ("", "p", "", "P"),
    ("", "r", "", "R"), ("", "t", "", "T"), ("", "v", "", "V"),
    ("", "w", "", "W"),
]


def _ctx_match(pattern: str, s: str, forward: bool) -> bool:
    """Match a context pattern against text. Supports literal chars, ' ' word
    edge, and '^' (one consonant)."""
    if not pattern:
        return True
    idx = 0
    text = s if forward else s[::-1]
    pat = pattern if forward else pattern[::-1]
    for p in pat:
        ch = text[idx] if idx < len(text) else " "
        if p == " ":
            if ch != " ":
                return False
        elif p == "^":
            if ch not in "bcdfghjklmnpqrstvwxz":
                return False
        elif p != ch:
            return False
        idx += 1
    return True


def rule_g2p(word: str) -> list[str]:
    """Letter-to-sound for one lowercase word."""
    w = f" {word} "
    phones: list[str] = []
    i = 1
    while i < len(w) - 1:
        for left, target, right, ph in _RULES:
            j = i + len(target)
            if w[i:j] != target:
                continue
            if not _ctx_match(left, w[:i], forward=False):
                continue
            if not _ctx_match(right, w[j:], forward=True):
                continue
            if ph:
                phones.extend(ph.split())
            i = j
            break
        else:
            i += 1  # unknown char — skip
    # keep at most one primary stress (first stressed vowel keeps 1)
    seen_primary = False
    out = []
    for p in phones:
        if p.endswith("1"):
            if seen_primary:
                p = p[:-1] + "0"
            seen_primary = True
        out.append(p)
    return out


class EnG2P:
    """Tiered G2P. ``cmudict_path``: optional CMUdict-format file."""

    def __init__(self, cmudict_path: str | None = None):
        self.cmu: dict[str, list[str]] = {}
        if cmudict_path:
            self.load_cmudict(cmudict_path)

    def load_cmudict(self, path: str) -> None:
        with open(path, encoding="latin-1") as f:
            for line in f:
                if line.startswith(";;;") or not line.strip():
                    continue
                word, _, prons = line.strip().partition("  ")
                word = word.lower()
                if "(" in word:  # alternate pronunciations — keep the first
                    continue
                self.cmu[word] = prons.split()

    def word_phones(self, word: str) -> list[str]:
        word = word.lower()
        if word in self.cmu:
            return list(self.cmu[word])
        if word in LEXICON:
            return LEXICON[word][0].split()
        return rule_g2p(word)

    def __call__(self, text: str) -> list[str]:
        """Sentence → phones with ' ' separators between words (the
        reference EnG2p contract, txt_processors/en.py:20-40)."""
        out: list[str] = []
        for word in re.findall(r"[a-z']+|[!,.?;:]", text.lower()):
            if re.search("[a-z]", word) is None:
                out.append(word)
            else:
                out.extend(self.word_phones(word))
            out.append(" ")
        return out[:-1] if out else []
