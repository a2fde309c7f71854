"""Port ``TTSEngine`` (``audiogpt_tpu_torch/engines/tts.py``) and
``BatchedTTS`` against the JAX engine on the same FastSpeech2 and HiFi-GAN
parameters (a tiny config): ``text_to_mel``, the fused chunk within one
int16 step, the clause chunking, long texts, batches, the unfused path, and
the streaming cap. Every text's rounded durations and pitch bins are
checked to lie far from their rounding boundaries first
(``test_torch_fastspeech2.assert_margins``)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines import tts as jtts
from audiogpt_tpu.engines.vocoder import VocoderEngine as JaxVocoderEngine
from audiogpt_tpu.models.tts import fastspeech2 as jfs
from audiogpt_tpu.models.vocoder import hifigan as jh
from audiogpt_tpu.models.vocoder import pwg as jp
from audiogpt_tpu.text import EnglishFrontend as JFE
from audiogpt_tpu.text import TokenTextEncoder as JTE
from audiogpt_tpu_torch.engines import tts
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.tts import fastspeech2 as pfs
from audiogpt_tpu_torch.models.vocoder import hifigan as ph
from audiogpt_tpu_torch.models.vocoder import pwg as pp
from audiogpt_tpu_torch.serving import BatchedTTS
from audiogpt_tpu_torch.text import (EnglishFrontend, TokenTextEncoder,
                                     default_arpabet_vocab)
from test_torch_fastspeech2 import assert_margins, fs2_params
from test_torch_hifigan import HIFI, MELGAN, engine_params, init_params

torch.set_num_threads(2)

#: one int16 step (the fused path's output) plus f32 slack
LSB = 1.0 / 32767 + 1e-6
#: f32 mels through a few layers on shared weights
ATOL = 1e-5
BUCKETS = (64,)
FS2 = dict(vocab_size=len(default_arpabet_vocab()) + 3, hidden_size=32,
           enc_layers=1, dec_layers=1, num_heads=2, dur_predictor_layers=2,
           predictor_layers=2, max_frames=512)

TEXTS = ["Hello world, this is a test.",
         "The quick brown fox jumps over 3 lazy dogs!",
         "Speech synthesis on the card.",
         "Why?"]
LONG = ("Once upon a time, in a land far away, there lived a curious cat. "
        "Every morning the cat would walk to the river, watch the water "
        "and listen to the birds; then, as the sun rose higher, it went "
        "home to sleep until the evening came again.")


#: the pitch predictor's f0 output centred on this coarse bin
PITCH_BIN = 60
FS2_F0_MEAN, FS2_F0_STD = 200.0, 60.0     # FastSpeech2Config's defaults


def tts_params(seed: int) -> dict:
    """FS2 params whose pitch stays inside one coarse bin: over the
    thousands of voiced frames of these texts, a random pitch would land
    within 10× the frameworks' difference (≈ 1e-4 of a bin) of a bin edge
    about as often as not. The f0 output's weights are scaled by 1e-3 (it
    still varies, by < 0.1 bin) and its bias puts it mid-bin; uv and the
    durations keep their random weights."""
    params = fs2_params(jfs.FastSpeech2Config(**FS2), seed=seed)
    out = params["params"]["pitch_predictor"]["out"]
    out["kernel"][:, 0] *= 1e-3
    mel = (PITCH_BIN - 1) * (jfs.F0_MEL_MAX - jfs.F0_MEL_MIN) \
        / (jfs.F0_BIN - 2) + jfs.F0_MEL_MIN
    f0 = 700.0 * np.expm1(mel / 1127.0)
    out["bias"][0] = (f0 - FS2_F0_MEAN) / FS2_F0_STD
    return params


@pytest.fixture(scope="module")
def engines():
    jcfg = jfs.FastSpeech2Config(**FS2)
    params = tts_params(seed=21)
    vparams = engine_params("hifigan", jh.HifiGANConfig(**HIFI), seed=22)
    jvoc = JaxVocoderEngine("hifigan", cfg=jh.HifiGANConfig(**HIFI),
                            params=vparams, buckets=(64, 512))
    jeng = jtts.TTSEngine(jcfg, params=params, vocoder=jvoc,
                          token_buckets=BUCKETS)
    voc = VocoderEngine("hifigan", cfg=ph.HifiGANConfig(**HIFI),
                        params=vparams, buckets=(64, 512), device="cpu")
    eng = tts.TTSEngine(pfs.FastSpeech2Config(**FS2), params=params,
                        vocoder=voc, token_buckets=BUCKETS, device="cpu")
    return jeng, eng, params


#: rows of the margin check's batch (one compiled JAX program)
MARGIN_ROWS = 8


def check_margins(jeng, eng, texts):
    """Duration, pitch and uv margins of ``texts`` (one padded batch)."""
    ids = [eng.frontend.encode(t) for t in texts]
    toks = np.zeros((MARGIN_ROWS, BUCKETS[0]), np.int32)
    for i, r in enumerate(ids):
        toks[i, :len(r)] = r
    fn = jax.jit(lambda p, t: jeng.model.apply(p, t, infer=True))
    ref = fn(jeng.params, jnp.asarray(toks))
    with torch.no_grad():
        got = eng.model(torch.from_numpy(toks).long())
    ref = {k: np.asarray(v)[:len(ids)] for k, v in ref.items()}
    got = {k: v.numpy()[:len(ids)] for k, v in got.items()}
    assert_margins(ref, got, eng.cfg)
    np.testing.assert_array_equal(got["mel2ph"], ref["mel2ph"])
    return ref


def test_text_to_mel_and_fused_chunk_match_jax(engines):
    jeng, eng, _ = engines
    ref = check_margins(jeng, eng, TEXTS)
    frames = (ref["mel2ph"] > 0).sum(1)
    assert (frames > 20).all() and (frames < FS2["max_frames"]).all()
    for text in TEXTS[:2]:
        jm, m = jeng.text_to_mel(text), eng.text_to_mel(text)
        assert m.shape == jm.shape and m.shape[1] == 80
        np.testing.assert_allclose(m, jm, atol=ATOL, rtol=0)
        jw, w = jeng.synthesize_chunk(text), eng.synthesize_chunk(text)
        assert w.dtype == np.float32 and w.shape == jw.shape
        assert len(w) == m.shape[0] * eng.vocoder.hop_size
        np.testing.assert_allclose(w, jw, atol=LSB, rtol=0)
        assert np.abs(w).max() > 0.01
        # int16 / 32767: every sample on the grid
        np.testing.assert_array_equal(np.round(w * 32767) / 32767, w)


def test_long_text_matches_jax(engines):
    """Clause chunks packed up to the 64-phone bucket, joined with 0.1 s
    gaps."""
    jeng, eng, _ = engines
    chunks = tts.split_for_buckets(
        eng.frontend, LONG, lambda pt: len(pt.phones) <= BUCKETS[0])
    assert chunks == jtts.split_for_buckets(
        jeng.frontend, LONG, lambda pt: len(pt.phones) <= BUCKETS[0])
    assert len(chunks) >= 3
    check_margins(jeng, eng, chunks)
    got, ref = eng(LONG), jeng(LONG)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=LSB, rtol=0)
    gap = int(0.1 * eng.sample_rate)
    first = len(eng.synthesize_chunk(chunks[0]))
    assert not got[first:first + gap].any()


def test_split_for_buckets_matches_jax():
    """Clause packing, then word bisection of a clause that still
    overflows, and a single word that cannot fit."""
    vocab = default_arpabet_vocab()
    fe, jfe = EnglishFrontend(TokenTextEncoder(vocab)), JFE(JTE(vocab))
    texts = [LONG, "word " * 40, "a, b; c. d! e? f: g", "supercalifragilistic",
             "short"]
    for cap in (8, 16, 30, 64):
        for text in texts:
            def fits(pt):
                return len(pt.phones) <= cap
            assert tts.split_for_buckets(fe, text, fits) == \
                jtts.split_for_buckets(jfe, text, fits)


def test_batch_synthesize_matches_single_calls_and_jax(engines):
    """Three texts ride one batch of 4 (the next power of two); a text over
    the largest bucket takes the chunked path."""
    jeng, eng, _ = engines
    texts = TEXTS[:3] + [LONG]
    got = eng.batch_synthesize(texts)
    ref = jeng.batch_synthesize(texts)
    for g, r, t in zip(got, ref, texts):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=LSB, rtol=0)
    for g, t in zip(got[:3], texts):
        # the same program per row: the batch changes no sample
        np.testing.assert_allclose(g, eng.synthesize_chunk(t), atol=LSB,
                                   rtol=0)
    np.testing.assert_array_equal(got[3], eng(LONG))


def test_batched_tts_four_threads(engines):
    """Four concurrent calls ride one ``batch_synthesize``; a long text
    runs on the caller's thread; a frontend error reaches the caller."""
    _, eng, _ = engines
    proxy = BatchedTTS(eng, max_batch=8, window_ms=500.0)
    out = [None] * 4
    try:
        def request(i):
            out[i] = proxy(TEXTS[i])

        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert (proxy.batcher.batches, proxy.batcher.items) == (1, 4)
        want = eng.batch_synthesize(TEXTS)
        for o, w in zip(out, want):
            np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(proxy(LONG), eng(LONG))
        assert proxy.batcher.batches == 1
        assert proxy.sample_rate == eng.sample_rate
        with pytest.raises(TypeError):
            proxy(None)
    finally:
        proxy.batcher.close()


class _Recorder:
    """The attributes ``synthesize_stream`` reads, recording the chunks it
    asks for."""

    def __init__(self, frontend, buckets):
        self.frontend = frontend
        self.sample_rate = 100
        self._fused_ok = True
        self.chunks = []
        self.bucketer = type("B", (), {"buckets": buckets})()

    def synthesize_chunk(self, text):
        self.chunks.append(text)
        return np.ones(3, np.float32)


@pytest.mark.parametrize("max_phones", [None, 0, 20, 64])
def test_synthesize_stream_caps_match_jax(engines, max_phones):
    jeng, eng, _ = engines
    mine, theirs = (_Recorder(eng.frontend, (32, 128)),
                    _Recorder(jeng.frontend, (32, 128)))
    pieces = list(tts.synthesize_stream(mine, LONG, max_phones=max_phones))
    list(jtts.synthesize_stream(theirs, LONG, max_phones=max_phones))
    assert mine.chunks == theirs.chunks
    assert len(pieces) == 2 * len(mine.chunks) - 1
    assert len(pieces[1]) == 10                # 0.1 s at 100 Hz


def test_negative_max_phones_raises(engines):
    """The JAX stream lets a negative cap through (the server's
    ``chunk_phones``, ``serving/server.py:286``); the port refuses it."""
    _, eng, _ = engines
    with pytest.raises(ValueError, match="max_phones"):
        next(tts.synthesize_stream(eng, LONG, max_phones=-1))


def test_unfused_vocoder_path_matches_jax(engines):
    """MelGAN has no fused pass in either package: ``text_to_mel`` →
    ``vocoder(mel)``, single and batched."""
    jeng, eng, params = engines
    vparams = engine_params("melgan", jp.MelGANConfig(
        upsample_scales=(4, 4), **MELGAN), seed=23)
    jvoc = JaxVocoderEngine("melgan", cfg=jp.MelGANConfig(
        upsample_scales=(4, 4), **MELGAN), params=vparams, buckets=(512,))
    voc = VocoderEngine("melgan", cfg=pp.MelGANConfig(
        upsample_scales=(4, 4), **MELGAN), params=vparams, buckets=(512,),
        device="cpu")
    j2 = jtts.TTSEngine(jeng.cfg, params=params, vocoder=jvoc,
                        token_buckets=BUCKETS)
    e2 = tts.TTSEngine(eng.cfg, params=params, vocoder=voc,
                       token_buckets=BUCKETS, device="cpu")
    assert not e2._fused_ok
    got, ref = e2(TEXTS[0]), j2(TEXTS[0])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    batch = e2.batch_synthesize(TEXTS[:2])
    np.testing.assert_allclose(batch[0], got, atol=ATOL, rtol=0)
    assert batch[1].shape == (len(e2.text_to_mel(TEXTS[1])) * 16,)


def test_nsf_vocoder_gets_no_f0_as_in_jax(engines):
    """With an NSF HiFi-GAN both engines take the unfused path and call the
    vocoder with the mel alone, so the source sees f0 = 0 on every frame
    (unvoiced noise) and FastSpeech2's ``f0_denorm`` is dropped: a JAX
    quirk the port copies for parity (ROADMAP §C). The key of the JAX
    vocoder's first call is replayed into the port's draws."""
    jeng, eng, params = engines
    jcfg = jh.HifiGANConfig(use_nsf=True, **HIFI)
    vparams = init_params(jh.HifiGANGenerator(jcfg), jnp.zeros((1, 16, 80)),
                          jnp.zeros((1, 16)), seed=24)
    jvoc = JaxVocoderEngine("hifigan", cfg=jcfg, params=vparams,
                            buckets=(512,))
    voc = VocoderEngine("hifigan", cfg=ph.HifiGANConfig(use_nsf=True, **HIFI),
                        params=vparams, buckets=(512,), device="cpu")
    j2 = jtts.TTSEngine(jeng.cfg, params=params, vocoder=jvoc,
                        token_buckets=BUCKETS)
    e2 = tts.TTSEngine(eng.cfg, params=params, vocoder=voc,
                       token_buckets=BUCKETS, device="cpu")
    assert not e2._fused_ok
    _, key = jax.random.split(jax.random.PRNGKey(0))
    k_noise, k_phase = jax.random.split(key)
    h = jcfg.harmonic_num + 1
    draws = (torch.from_numpy(np.array(jax.random.uniform(k_phase,
                                                          (1, 1, h)))),
             torch.from_numpy(np.array(jax.random.normal(
                 k_noise, (1, 512 * voc.hop_size, h)))))
    f0s = []
    vocode = voc.vocode

    def replayed(mel, f0=None, noise=None):
        f0s.append(f0)
        return vocode(mel, f0, noise=draws)

    voc.vocode = replayed
    got, ref = e2(TEXTS[0]), j2(TEXTS[0])
    assert f0s == [None]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_engine_defaults_and_device_rule(engines, monkeypatch):
    with pytest.raises(ValueError, match="phones exceed"):
        engines[1].synthesize_chunk(LONG)       # over the 64-phone bucket
    eng = tts.TTSEngine(device="cpu")
    assert (eng.cfg.hidden_size, eng.cfg.max_frames, eng.cfg.vocab_size) \
        == (256, 1024, len(TokenTextEncoder(default_arpabet_vocab())))
    assert (eng.vocoder.kind, eng.sample_rate, eng._fused_ok) == \
        ("hifigan", 22050, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tts.TTSEngine()
