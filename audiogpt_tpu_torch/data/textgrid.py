"""MFA TextGrid ingestion → frame-level phone alignment (``mel2ph``).

Counterpart of ``audiogpt_tpu/data/textgrid.py``, copied (pure Python and
numpy). The reference binarizer consumes Praat TextGrids written by the
Montreal Forced Aligner (``base_binarizer.py:188 get_align`` →
``data_gen_utils.py:274 get_mel2ph``; parser at ``data_gen_utils.py:197``):

  * the LAST IntervalTier carries the phones (MFA writes words, phones)
  * silence-ish interval labels ('sil', 'sp', '', 'SIL', 'PUNC') merge into
    one silent gap
  * silence *phonemes* in the phone list (anything not starting with a
    letter — punctuation, <BOS>/<EOS>) absorb the silent intervals; when a
    silent phone has no matching gap it gets zero duration
  * phone boundaries land on frames via round(t · sr / hop), and every frame
    belongs to exactly one phone (mel2ph is 1-based; 0 would be padding)
"""

from __future__ import annotations

import re

import numpy as np


def is_sil_phoneme(p: str) -> bool:
    """Reference rule (data_gen_utils.py:351): silence/punctuation tokens
    don't start with a letter."""
    return not p or not p[0].isalpha()


_SIL_LABELS = {"sil", "sp", "", "SIL", "PUNC", "spn"}

_INTERVAL_RE = re.compile(
    r"intervals\s*\[\d+\]\s*:?\s*"
    r"xmin\s*=\s*([\d.eE+-]+)\s*"
    r"xmax\s*=\s*([\d.eE+-]+)\s*"
    r'text\s*=\s*"(.*?)"', re.S)


def parse_textgrid(text: str) -> list[tuple[str, list[tuple[float, float, str]]]]:
    """Long-format TextGrid → ``[(tier_name, [(xmin, xmax, label), ...])]``
    for every IntervalTier, in file order."""
    tiers = []
    chunks = re.split(r"item\s*\[\d+\]\s*:", text)
    for chunk in chunks[1:]:
        cls = re.search(r'class\s*=\s*"(.*?)"', chunk)
        if cls is None or cls.group(1) != "IntervalTier":
            continue
        name = re.search(r'name\s*=\s*"(.*?)"', chunk)
        items = [(float(a), float(b), t.strip())
                 for a, b, t in _INTERVAL_RE.findall(chunk)]
        tiers.append((name.group(1) if name else "", items))
    if not tiers:
        raise ValueError("no IntervalTier found in TextGrid")
    return tiers


def _merged_phone_tier(text: str) -> list[tuple[float, float, str]]:
    """Last tier (MFA phones), silence labels normalized to '' and
    consecutive silences merged (get_mel2ph's tg_align_ pass)."""
    intervals = parse_textgrid(text)[-1][1]
    out: list[list] = []
    for xmin, xmax, label in intervals:
        if label in _SIL_LABELS:
            label = ""
            if out and out[-1][2] == "":
                out[-1][1] = xmax
                continue
        out.append([xmin, xmax, label])
    return [tuple(iv) for iv in out]


def mel2ph_from_textgrid(tg_text: str, phones: list[str], n_frames: int,
                         sr: int, hop: int) -> tuple[np.ndarray, np.ndarray]:
    """TextGrid + phone list → (mel2ph [n_frames] int32 1-based,
    durations [n_phones] int32). Raises ValueError when the TextGrid's
    non-silent phone count doesn't match the phone list (the reference's
    BinarizationError 'Align does not match')."""
    tg = _merged_phone_tier(tg_text)
    n_tg = sum(1 for iv in tg if iv[2] != "")
    n_ph = sum(1 for p in phones if not is_sil_phoneme(p))
    if n_tg != n_ph:
        raise ValueError(
            f"TextGrid/phone mismatch: {n_tg} aligned phones vs {n_ph} "
            f"non-silent phones in {phones}")

    # walk both sequences, recording each phone's start time (reference
    # get_mel2ph split[] walk, data_gen_utils.py:281-325)
    split = np.full(len(phones) + 1, -1.0)
    ph_i = tg_i = 0
    while tg_i < len(tg) or ph_i < len(phones):
        if tg_i == len(tg):                       # trailing sil phones
            split[ph_i] = np.inf
            ph_i += 1
            continue
        xmin, xmax, label = tg[tg_i]
        if label == "" and ph_i == len(phones):   # trailing sil interval
            tg_i += 1
            continue
        ph = phones[ph_i]
        if label != "" and is_sil_phoneme(ph):
            # silent phone with no gap in the TextGrid: zero duration,
            # boundary back-filled from the next real phone
            ph_i += 1
            continue
        if label == "" and not is_sil_phoneme(ph):
            raise ValueError(
                f"unexpected silence interval at {xmin:.3f}s while "
                f"expecting phone {ph!r}")
        split[ph_i] = xmin
        if ph_i > 0 and split[ph_i - 1] == -1.0 \
                and is_sil_phoneme(phones[ph_i - 1]):
            split[ph_i - 1] = xmin
        ph_i += 1
        tg_i += 1

    split[0] = 0.0
    split[-1] = np.inf
    # zero-duration sil phones that never got a boundary inherit the next one
    for i in range(len(split) - 2, -1, -1):
        if split[i] == -1.0:
            split[i] = split[i + 1]

    # round-half-up, the reference's int(s*sr/hop + 0.5)
    frames = [min(int(s * sr / hop + 0.5), n_frames) if np.isfinite(s)
              else n_frames for s in split]
    frames[0] = 0
    mel2ph = np.zeros(n_frames, np.int32)
    for i in range(len(phones)):
        mel2ph[frames[i]:frames[i + 1]] = i + 1
    dur = np.bincount(mel2ph, minlength=len(phones) + 1)[1:].astype(np.int32)
    return mel2ph, dur
