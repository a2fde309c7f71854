"""The port's English TTS frontend (``audiogpt_tpu_torch/text/``: its own
copies of the JAX package's ``encoder``, ``norm_en``, ``en_g2p`` and
``frontend``) against the JAX package's: words, phones, ``ph2word`` and ids
exactly equal over sentences that reach every tier of the normaliser and
the G2P."""

import pytest

from audiogpt_tpu import text as jax_text
from audiogpt_tpu.text.en_g2p import EnG2P as JaxEnG2P
from audiogpt_tpu.text.norm_en import normalize_numbers as jax_norm
from audiogpt_tpu_torch import text
from audiogpt_tpu_torch.text.en_g2p import EnG2P
from audiogpt_tpu_torch.text.norm_en import normalize_numbers

SENTENCES = [
    "Hello world, this is a test.",
    "I have 3 dogs and 1,234,567 cats.",
    "She finished 1st, he came 22nd and they were 103rd.",
    "It costs $5.99, not $1 or $0.01, and $1,000 in all.",
    "Pi is about 3.14159 and e is 2.718.",
    "Café naïve résumé, über-cool façade.",
    "Wait... what?!? No way!!! Really;; okay::",
    "A well-known state-of-the-art text-to-speech system.",
    "Xylophone quixotic zephyr phlegm gnarly knight wrought.",
    "The (quoted) \"words\" don't vanish, i.e. etc. remain.",
    "",
    "12",
    "Synthesize speech, given the user's input text!",
]


@pytest.fixture(scope="module")
def frontends():
    vocab = text.default_arpabet_vocab()
    assert vocab == jax_text.default_arpabet_vocab()
    return (jax_text.EnglishFrontend(jax_text.TokenTextEncoder(vocab)),
            text.EnglishFrontend(text.TokenTextEncoder(vocab)))


@pytest.mark.parametrize("sentence", SENTENCES)
def test_frontend_equals_jax(frontends, sentence):
    jfe, fe = frontends
    ref, got = jfe(sentence), fe(sentence)
    assert got.text == ref.text
    assert got.words == ref.words
    assert got.phones == ref.phones
    assert got.ph2word == ref.ph2word
    assert fe.encode(sentence) == jfe.encode(sentence)
    assert text.preprocess_text(sentence) == ref.text


@pytest.mark.parametrize("sentence", SENTENCES)
def test_normalizer_and_g2p_equal_jax(sentence):
    assert normalize_numbers(sentence) == jax_norm(sentence)
    norm = text.preprocess_text(sentence)
    assert EnG2P()(norm) == JaxEnG2P()(norm)


def test_cmudict_tier_equals_jax(tmp_path):
    """A CMUdict file overrides the lexicon and the rules; alternates and
    comments are skipped."""
    path = tmp_path / "cmudict.txt"
    path.write_text(";;; comment\nHELLO  HH EH0 L OW1\nHELLO(1)  HH AH0 L OW1\n"
                    "ZYX  Z IH1 K S\n", encoding="latin-1")
    for word in ("hello", "zyx", "world", "quixote"):
        assert EnG2P(str(path)).word_phones(word) == \
            JaxEnG2P(str(path)).word_phones(word)
    assert EnG2P(str(path)).word_phones("hello") == ["HH", "EH0", "L", "OW1"]


def test_token_encoder_equals_jax(tmp_path):
    vocab = ["AH0", "B", "|", "<BOS>"]
    enc, jenc = text.TokenTextEncoder(vocab), jax_text.TokenTextEncoder(vocab)
    phones = "<BOS> AH0 B | ZZ AH0"
    assert enc.encode(phones) == jenc.encode(phones) == [6, 3, 4, 5, 2, 3]
    assert enc.decode([6, 3, 0, 1], strip_padding=True) == \
        jenc.decode([6, 3, 0, 1], strip_padding=True) == "<BOS> AH0"
    assert enc.decode([3, 1, 4], strip_eos=True) == "AH0"
    assert enc.decode([99]) == jenc.decode([99]) == "ID_99"
    assert (len(enc), enc.seg_index) == (len(jenc), jenc.seg_index) == (7, 5)
    assert (text.PAD, text.EOS, text.UNK, text.SEG) == \
        (jax_text.PAD, jax_text.EOS, jax_text.UNK, jax_text.SEG)
    path = tmp_path / "phone_set.json"
    enc.save(str(path))
    again = text.TokenTextEncoder.from_file(str(path))
    assert again.encode(phones) == enc.encode(phones)
    assert jax_text.TokenTextEncoder.from_file(str(path)).encode(phones) == \
        enc.encode(phones)
