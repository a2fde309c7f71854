"""The port's text and audio I/O against the JAX package: the bundled CLIP
BPE codec, the whisper detokenizer and non-speech ids, ``load_bpe_dir`` on
a tiny GPT-2 vocab, the polyphase ``resample`` against JAX's zero-stuffed
convolution, and the wav round trip through ``load_wav``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.dsp.resample import resample as jax_resample
from audiogpt_tpu.text import bpe as jbpe
from audiogpt_tpu.utils.audio_io import load_wav as jax_load_wav
from audiogpt_tpu_torch.dsp.resample import output_length, resample
from audiogpt_tpu_torch.text import bpe as pbpe
from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav

TEXTS = [
    "a dog barks in the rain",
    "Hello, World! It's 2024: naïve café, ½ Ⅻ ²³ 一二三 日本語のテキスト",
    "  multiple   spaces\tand\nnewlines ",
    "<start_of_text>tagged<end_of_text> &amp; html",
    "♪♪ music (( )) [[x]] -- 'll 've 'd",
    "emoji 😀🎵 ١٢٣ digits 0123456789",
    "",
]


@pytest.fixture(scope="module")
def clip_codecs():
    return pbpe.load_clip_bpe(), jbpe.load_clip_bpe()


def test_clip_bpe_matches_jax(clip_codecs):
    port, ref = clip_codecs
    assert port.vocab_size == ref.vocab_size == 49408
    for text in TEXTS:
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert port.decode(ids) == ref.decode(ids)
        assert port.decode(ids, skip_special=False) == \
            ref.decode(ids, skip_special=False)


def test_whisper_detokenizer_and_non_speech_ids_match_jax(clip_codecs):
    port, ref = clip_codecs
    assert pbpe.non_speech_ids(port) == jbpe.non_speech_ids(ref)
    assert pbpe.NON_SPEECH_SYMBOLS == jbpe.NON_SPEECH_SYMBOLS
    pdet = pbpe.WhisperDetokenizer(port)
    jdet = jbpe.WhisperDetokenizer(ref)
    for text in TEXTS:
        ids = ref.encode(text) + [50257, 50364, 50258]   # specials dropped
        assert pdet(ids) == jdet(ids)


def test_gpt2_word_splitter_matches_jax():
    """The splitter that ``re`` builds from unicodedata's letter and number
    classes finds the pieces ``regex``'s \\p{L} / \\p{N} find."""
    pat = pbpe._word_patterns()[1]
    for text in TEXTS:
        assert pat.findall(text) == jbpe._GPT2_PAT.findall(text)


def test_load_bpe_dir_on_a_tiny_vocab(tmp_path):
    """A GPT-2 layout (vocab.json + merges.txt + added_tokens.json) and the
    same vocab as tokenizer.json: both loaders agree with the JAX ones."""
    table = pbpe.byte_unicode_table()
    units = [table[b] for b in range(256)]
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w"), ("o", "r")]
    vocab = {u: i for i, u in enumerate(units)}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
        encoding="utf-8")
    (tmp_path / "added_tokens.json").write_text(
        json.dumps({"<|startoftranscript|>": len(vocab)}), encoding="utf-8")
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "tokenizer.json").write_text(json.dumps({
        "model": {"vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
        "added_tokens": [{"id": vocab["<|endoftext|>"],
                          "content": "<|endoftext|>"}]}), encoding="utf-8")
    text = "hello world<|endoftext|> Hello, ok"
    for path in (str(tmp_path), str(hf)):
        port, ref = pbpe.load_bpe_dir(path), jbpe.load_bpe_dir(path)
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert vocab["hell"] in ids and vocab["Ġw"] in ids
        assert port.decode(ids) == ref.decode(ids) == "hello world Hello, ok"
        assert port.specials == ref.specials
    with pytest.raises(FileNotFoundError):
        pbpe.load_bpe_dir(str(tmp_path / "missing"))


@pytest.mark.parametrize("orig,target", [(44100, 16000), (22050, 16000),
                                         (16000, 24000), (8000, 24000)])
def test_resample_matches_jax(orig, target):
    """JAX's outputs; at 8 → 24 kHz the zero-stuffed convolution ends one sample short of
    ``output_length`` and JAX pads it with 0: the port does the same."""
    x = np.random.RandomState(orig % 97).randn(2, 4410).astype(np.float32)
    ref = np.asarray(jax_resample(jnp.asarray(x), orig, target))
    got = resample(torch.from_numpy(x), orig, target).numpy()
    assert got.shape == ref.shape == (2, output_length(4410, orig, target))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_wav_round_trip_and_resampled_load(tmp_path):
    """16-bit PCM written and read back to within two steps (the write
    truncates at a scale of 32767, the read divides by 32768); a
    44.1 kHz file loaded at 16 kHz equals the JAX package's ``load_wav`` of
    it."""
    t = np.arange(44100 // 4) / 44100.0
    wav = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    path = str(tmp_path / "tone.wav")
    save_wav(wav, path, 44100)
    back, sr = load_wav(path)
    assert sr == 44100 and back.dtype == np.float32
    np.testing.assert_allclose(back, wav, atol=2.0 / 32767, rtol=0)
    got, sr = load_wav(path, 16000, device="cpu")
    ref, ref_sr = jax_load_wav(path, 16000)
    assert sr == ref_sr == 16000 and got.shape == ref.shape == (4000,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    stereo = str(tmp_path / "stereo.wav")
    from scipy.io import wavfile
    wavfile.write(stereo, 16000, np.stack([wav, -wav], 1))
    mono, _ = load_wav(stereo)
    np.testing.assert_allclose(mono, 0.0, atol=1e-7)
