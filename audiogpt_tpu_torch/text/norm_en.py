"""English text normalization: numbers → words.

Copy of ``audiogpt_tpu/text/norm_en.py``.

Self-contained replacement for ``g2p_en.expand.normalize_numbers`` used by the
reference (``data_gen/tts/txt_processors/en.py:4``) — that wheel isn't in this
image. Covers cardinals, ordinals, decimals, currency, and comma grouping.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = ["", " thousand", " million", " billion", " trillion"]

_ORD_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _three_digits(n: int) -> str:
    out = []
    if n >= 100:
        out.append(_ONES[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        t = _TENS[n // 10]
        if n % 10:
            t += " " + _ONES[n % 10]
        out.append(t)
    elif n > 0:
        out.append(_ONES[n])
    return " ".join(out)


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n == 0:
        return "zero"
    parts = []
    group = 0
    while n > 0:
        n, rem = divmod(n, 1000)
        if rem:
            parts.append(_three_digits(rem) + _SCALE[group])
        group += 1
    return " ".join(reversed(parts))


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORD_IRREGULAR:
        last = _ORD_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    elif last.endswith("t"):
        last = last + "h"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _expand_dollars(m: re.Match) -> str:
    whole = int(m.group(1).replace(",", ""))
    cents = int(m.group(2) or 0)
    out = []
    if whole:
        out.append(number_to_words(whole) + (" dollar" if whole == 1 else " dollars"))
    if cents:
        out.append(number_to_words(cents) + (" cent" if cents == 1 else " cents"))
    return " ".join(out) or "zero dollars"


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1), m.group(2)
    digits = " ".join(_ONES[int(d)] for d in frac)
    return f"{number_to_words(int(whole))} point {digits}"


def normalize_numbers(text: str) -> str:
    text = re.sub(r"\$([0-9][0-9,]*)(?:\.([0-9]{2}))?", _expand_dollars, text)
    text = re.sub(r"([0-9]+)\.([0-9]+)", _expand_decimal, text)
    text = re.sub(
        r"\b([0-9]+)(st|nd|rd|th)\b", lambda m: ordinal_to_words(int(m.group(1))), text
    )
    text = re.sub(r"[0-9][0-9,]*", lambda m: number_to_words(int(m.group(0).replace(",", ""))), text)
    return text
