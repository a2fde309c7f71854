"""Text codecs of the port: the English TTS frontend (``frontend``,
``en_g2p``, ``norm_en``, ``encoder``), the SVS pinyin splitter (``zh``),
byte-level BPE (``bpe.py``), the SentencePiece unigram codec of the T5
tower (``sentencepiece.py``) and the bundled data (``data/``).

Counterpart of ``audiogpt_tpu/text/__init__.py``; every module here is the
port's own copy."""

from audiogpt_tpu_torch.text.encoder import (EOS, PAD, SEG,  # noqa: F401
                                             UNK, TokenTextEncoder)
from audiogpt_tpu_torch.text.frontend import (EnglishFrontend,  # noqa: F401
                                              ProcessedText,
                                              preprocess_text)
from audiogpt_tpu_torch.text.bpe import (ByteBPE,  # noqa: F401
                                         ClipTokenizer, WhisperDetokenizer,
                                         load_bpe_dir, load_clip_bpe)


def default_arpabet_vocab() -> list[str]:
    """Built-in ARPAbet phone set covering the rule-based G2P's output
    space: stressed vowels + consonants + word separator, punctuation and
    BOS/EOS specials (shared by the TTS/style-transfer engines)."""
    vowels = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER",
              "EY", "IH", "IY", "OW", "OY", "UH", "UW"]
    return sorted(
        [v + s for v in vowels for s in "012"]
        + ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L",
           "M", "N", "NG", "P", "R", "S", "SH", "T", "TH", "V",
           "W", "Y", "Z", "ZH"]
        + ["|", "<BOS>", "<EOS>", "!", ",", ".", "?", ";", ":"])
