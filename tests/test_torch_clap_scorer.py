"""Port CLAP scorer (BERT CLS projection against the PANN / Cnn14 audio
tower) against the JAX ``CLAPScorer``, with the JAX text params and the
audio tower's params and ``batch_stats`` carried across."""

import jax
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.caption.cnn14 import Cnn14Config as JaxCnn14Config
from audiogpt_tpu.models.textenc import BertConfig as JaxBertConfig
from audiogpt_tpu.models.textenc import CLAPTextConfig as JaxCLAPConfig
from audiogpt_tpu.models.textenc import CLAPTextEncoder as JaxCLAPText
from audiogpt_tpu.models.textenc.clap import CLAPAudioEncoder as JaxCLAPAudio
from audiogpt_tpu.models.textenc.clap import CLAPScorer as JaxCLAPScorer
from audiogpt_tpu_torch.models.caption import Cnn14Config
from audiogpt_tpu_torch.models.textenc import (
    BertConfig,
    CLAPScorer,
    CLAPTextConfig,
)
from test_torch_cnn14 import random_variables

torch.set_num_threads(2)

BERT = dict(vocab_size=30522, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=80)
CHANNELS = (4, 4, 8, 8, 16, 16)
TEXTS = ["a dog barks in the rain", "thunder"]


def jax_scorer_params(d_proj=24, seed=0):
    """The JAX scorer's text and audio variables, from ``jax.eval_shape``
    and numpy fills (no init is compiled)."""
    text = JaxCLAPText(JaxCLAPConfig(bert=JaxBertConfig(**BERT), d_proj=d_proj,
                                     max_length=16))
    audio = JaxCLAPAudio(d_proj, cnn14=JaxCnn14Config(channels=CHANNELS))
    tp = random_variables(jax.eval_shape(
        text.init, jax.random.PRNGKey(0), np.zeros((1, 4), np.int32)), seed)
    ap = random_variables(jax.eval_shape(
        audio.init, jax.random.PRNGKey(1), np.zeros((1, 16000), np.float32)),
        seed + 1)
    return tp, ap


def make_scorers(d_proj=24, seed=0):
    tp, ap = jax_scorer_params(d_proj, seed)
    jsc = JaxCLAPScorer(
        JaxCLAPConfig(bert=JaxBertConfig(**BERT), d_proj=d_proj,
                      max_length=16),
        text_params=tp, audio_params=ap, sample_rate=16000,
        audio_cfg=JaxCnn14Config(channels=CHANNELS))
    sc = CLAPScorer(
        CLAPTextConfig(bert=BertConfig(**BERT), d_proj=d_proj, max_length=16),
        text_params=tp, audio_params=ap, sample_rate=16000,
        audio_cfg=Cnn14Config(channels=CHANNELS), device="cpu")
    return jsc, sc


def _wavs(n, length, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 16000.0
    tones = np.sin(2 * np.pi * np.asarray([220.0, 880.0, 3000.0])[:n, None]
                   * t)
    return (0.2 * rng.randn(n, length) + 0.5 * tones).astype(np.float32)


def test_scorer_matches_jax():
    jsc, sc = make_scorers()
    wavs = _wavs(3, 40000, seed=0)
    for text in TEXTS:
        ref = jsc.score(text, wavs)
        got = sc.score(text, wavs)
        assert got.shape == (3,) and got.dtype == np.float32
        # cosine similarities in [-1, 1] from two f32 towers with shared
        # weights: 1e-5 absolute
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        assert sc.select_best(text, wavs) == jsc.select_best(text, wavs)
    np.testing.assert_allclose(sc.score(TEXTS[0], wavs[1]),
                               jsc.score(TEXTS[0], wavs[1]), atol=1e-5)


def test_scorer_rejects_what_is_not_ported():
    """An unknown tower name, and a tower config of another class: the
    JAX package's ``Cnn14Config`` under ``pann``, a ``Cnn14Config`` under
    ``htsat`` (both towers are ported)."""
    with pytest.raises(ValueError, match="unknown CLAPScorer audio_tower"):
        CLAPScorer(audio_tower="vggish", device="cpu")
    with pytest.raises(TypeError):
        CLAPScorer(audio_cfg=JaxCnn14Config(channels=CHANNELS), device="cpu")
    with pytest.raises(TypeError):
        CLAPScorer(audio_tower="htsat", audio_cfg=Cnn14Config(
            channels=CHANNELS), device="cpu")


def test_scorer_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CLAPScorer(CLAPTextConfig(bert=BertConfig(**BERT), d_proj=24),
                   audio_cfg=Cnn14Config(channels=CHANNELS))
