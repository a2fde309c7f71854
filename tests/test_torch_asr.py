"""Port ``ASREngine`` (``audiogpt_tpu_torch/engines/asr.py``) against the JAX
engine on the same whisper parameters (a tiny config with whisper's full
vocab, 1 s windows): tokens, text through the whole temperature-fallback
ladder with JAX's draws replayed, segments, language detection, batches and
windowed long audio; the bf16 engine within JAX's own f32-vs-bf16 gap; the
three behaviours of the JAX engine the port does not copy; and
``BatchedASR`` coalescing concurrent calls."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.asr import ASREngine as JaxASREngine
from audiogpt_tpu.engines.asr import dedup_join as jax_dedup_join
from audiogpt_tpu.models.asr import whisper as jw
from audiogpt_tpu_torch.engines import ASREngine
from audiogpt_tpu_torch.engines import asr as pasr
from audiogpt_tpu_torch.models.asr import whisper as pw
from audiogpt_tpu_torch.serving import BatchedASR
from test_torch_whisper import TINY, whisper_params

torch.set_num_threads(2)

MAX_TOKENS = 8
SR = 16000
#: one layer each way: the engine's logic, not the model's depth, is under
#: test here (tests/test_torch_whisper.py holds the two-layer model)
CFG = dict(TINY, n_audio_layer=1, n_text_layer=1)


@pytest.fixture(scope="module")
def engines():
    cfg = jw.WhisperConfig(**CFG)
    _, params = whisper_params(cfg, seed=3)
    jeng = JaxASREngine(cfg, params=params, max_tokens=MAX_TOKENS)
    eng = ASREngine(pw.WhisperConfig(**CFG), params=params,
                    max_tokens=MAX_TOKENS, device="cpu")
    return jeng, eng, params


def _clip(seed, seconds=1.0):
    rng = np.random.RandomState(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    return (0.2 * np.sin(2 * np.pi * (200.0 + 100 * seed) * t)
            + 0.05 * rng.randn(n)).astype(np.float32)


def _long(seed):
    """A 2.5 s clip: three overlapping 1 s windows (0.25 s halo), which
    ride one padded batch of 4. The JAX tests below run at that batch, so
    the JAX engine compiles one program per decode mode."""
    return np.concatenate([_clip(seed), _clip(seed + 1),
                           _clip(seed + 2, 0.5)])


def _rows(seed):
    """Four 1 s clips, [4, T]."""
    return np.stack([_clip(seed + i) for i in range(4)])


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_draws(base_rng, attempt, batch, vocab, max_tokens):
    """The Gumbel draws of JAX's decode at ladder rung ``attempt``
    (``fold_in(base_rng, attempt)``, split as JAX's decode splits it), in
    one program: ``[max_tokens + 1, batch, vocab]``."""
    k0, k_rest = jax.random.split(jax.random.fold_in(base_rng, attempt))
    keys = jnp.concatenate([k0[None], jax.random.split(k_rest, max_tokens)])
    return jax.vmap(lambda k: jax.random.gumbel(k, (batch, vocab),
                                                jnp.float32))(keys)


def _replay_jax_draws(eng, jeng):
    """Make the port engine sample with the Gumbel draws the JAX engine
    makes at each ladder rung."""
    def noise(attempt, batch):
        draws = np.array(_jax_draws(jeng._base_rng, attempt, batch,
                                    eng.cfg.n_vocab, eng.max_tokens))
        return list(torch.from_numpy(draws))
    return noise


def test_transcribe_tokens_matches_jax(engines):
    jeng, eng, _ = engines
    wav = _rows(0)
    ref = jeng.transcribe_tokens(wav, language=3)
    got = eng.transcribe_tokens(wav, language=3)
    assert got.shape == (4, 4 + MAX_TOKENS)
    np.testing.assert_array_equal(got, ref)


def test_transcribe_text_through_the_ladder_matches_jax(engines,
                                                        monkeypatch):
    """Auto language (one re-dispatch) and the default six-rung ladder over
    three windows: the random weights fail the logprob bar at every rung,
    so each window's text is the t = 1.0 rung's, sampled with JAX's
    draws."""
    jeng, eng, _ = engines
    monkeypatch.setattr(eng, "_noise", _replay_jax_draws(eng, jeng))
    calls = []
    real = pasr.decode
    monkeypatch.setattr(pasr, "decode", lambda *a, **kw: calls.append(
        kw["temperature"]) or real(*a, **kw))
    wav = _long(1)
    ref = jeng.transcribe(wav)
    got = eng.transcribe(wav)
    assert got == ref and got.strip()
    # rung 0 twice (the language re-dispatch), then the five others
    assert calls == [0.0, 0.0, 0.2, 0.4, 0.6, 0.8, 1.0]


def test_return_segments_matches_jax(engines):
    """Timestamp mode over three windows: each segment kept by the window
    that owns its midpoint, times in the clip's frame."""
    jeng, eng, _ = engines
    wav = _long(2)
    jeng.temperatures = eng.temperatures = (0.0,)
    try:
        ref = jeng.transcribe(wav, language=5, return_segments=True)
        got = eng.transcribe(wav, language=5, return_segments=True)
    finally:
        jeng.temperatures = eng.temperatures = (0.0, 0.2, 0.4, 0.6, 0.8,
                                                1.0)
    assert got == ref and got
    assert all(0.0 <= s <= e <= 2.5 for s, e, _ in got)


def test_detect_language_matches_jax_without_a_decode(engines, monkeypatch):
    """The port reads the language softmax off the prime alone: one
    decoder forward, where the JAX engine runs the whole decode."""
    jeng, eng, _ = engines
    wav = _rows(3)
    ref_idx, ref = jeng.detect_language(wav)
    forwards = []
    hook = eng.model.decoder.register_forward_hook(
        lambda *a: forwards.append(1))
    monkeypatch.setattr(pasr, "decode", None)   # no decode loop may run
    try:
        idx, probs = eng.detect_language(wav)
    finally:
        hook.remove()
    assert len(forwards) == 1
    assert probs.shape == (4, 99)
    np.testing.assert_allclose(probs, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(idx, ref_idx)


def test_transcribe_batch_and_long_audio_match_jax(engines):
    """Three clips ride one padded batch of 4; a 2.5 s clip becomes three
    overlapping 1 s windows (0.25 s halo) joined at the seams."""
    jeng, eng, _ = engines
    jeng.temperatures = eng.temperatures = (0.0,)
    try:
        wavs = [_clip(4, 0.5), _clip(5), _clip(6, 1.5)]
        ref = jeng.transcribe_batch(wavs)
        got = eng.transcribe_batch(wavs)
        long = _long(7)
        assert eng._windows(long)[0].shape == (3, SR)
        ref_long = jeng.transcribe(long, language=2)
        got_long = eng.transcribe(long, language=2)
    finally:
        jeng.temperatures = eng.temperatures = (0.0, 0.2, 0.4, 0.6, 0.8,
                                                1.0)
    assert got == ref and len(got) == 3
    assert got_long == ref_long and got_long


@pytest.mark.parametrize("texts", [
    ["the cat sat on", "on the mat"],
    ["A b c", "B C d", ""],
    ["one two three four five six seven eight nine",
     "two three four five six seven eight nine ten"],
])
def test_dedup_join_matches_jax(texts):
    assert pasr.dedup_join(texts) == jax_dedup_join(texts)


@pytest.mark.parametrize("text", ["a b c d", "la " * 40])
def test_fallback_and_no_speech_gate_match_jax(engines, text):
    """The ladder's retry test and the no-speech gate at whisper's
    thresholds (compression 2.4, logprob −1, no-speech 0.6), on both sides
    of each bar."""
    jeng, eng, _ = engines
    for avg_lp in (-2.0, -1.0, -0.5):
        assert eng._needs_fallback(text, avg_lp) == \
            jeng._needs_fallback(text, avg_lp)
        for ns in (0.2, 0.6, 0.9):
            assert eng._gated(avg_lp, ns) == \
                (jeng._finalize(text, avg_lp, ns) == "")


def rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def test_bf16_engine_within_jax_f32_vs_bf16_gap(engines):
    """``bf16=True`` on both sides: the encoder output and the prime's
    logits of the port's bf16 engine lie within the distance between JAX's
    f32 and bf16 engines."""
    jeng, _, params = engines
    jb = JaxASREngine(jeng.cfg, params=params, max_tokens=MAX_TOKENS,
                      bf16=True)
    pb = ASREngine(pw.WhisperConfig(**CFG), params=params,
                   max_tokens=MAX_TOKENS, bf16=True, device="cpu")
    assert all(p.dtype == torch.float32 for p in pb.model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in pb._run.parameters())
    mel = np.asarray(jw.whisper_log_mel(jnp.asarray(_rows(10))))
    prompt = jnp.asarray(jeng._prompts(4, "translate", 0))

    def jax_prime(p, dtype):
        xa = jeng.model.apply(p, jnp.asarray(mel).astype(dtype),
                              method=jw.WhisperModel.encode)
        return xa.astype(jnp.float32), jeng.model.apply(
            p, prompt, xa, method=lambda m, t, x: m.decoder(t, x)).astype(
            jnp.float32)

    # both engines' forwards in one program: one compile
    ref32, ref16 = jax.jit(lambda p32, p16: (
        jax_prime(p32, jnp.float32), jax_prime(p16, jnp.bfloat16)))(
        jeng._run_params, jb._run_params)
    ref32 = [np.asarray(a) for a in ref32]
    ref16 = [np.asarray(a) for a in ref16]
    with torch.inference_mode():
        xa = pb._run.encode(torch.from_numpy(mel).bfloat16())
        logits = pw.prime(pb._run, torch.from_numpy(mel),
                          torch.from_numpy(np.asarray(prompt)).long(),
                          4)[2]
    assert xa.dtype == torch.bfloat16
    # each framework rounds to bf16 at other points, so the two bf16 runs
    # are about √2 times as far apart as each is from f32 (encoder RMS
    # 5.4e-3 against JAX's 5.1e-3 gap at this seed): the port's bf16 output
    # is held as far from the f32 output as JAX's is (RMS, 25 % slack), and
    # within twice JAX's gap of JAX's bf16 output everywhere
    for got, r16, r32 in zip((xa.float(), logits), ref16, ref32):
        got = got.numpy()
        gap = np.abs(r16 - r32)
        assert 0.0 < gap.max()
        assert rms(got - r32) <= 1.25 * rms(r16 - r32)
        assert np.abs(got - r16).max() <= 2.0 * gap.max()
    toks = pb.transcribe_tokens(_clip(10))
    assert toks.shape == (1, 4 + MAX_TOKENS)


def test_transcribe_takes_one_stream(engines):
    _, eng, _ = engines
    eng.temperatures = (0.0,)
    try:
        wav = _clip(11)
        assert eng.transcribe(wav[None], language=1) == \
            eng.transcribe(wav, language=1)
        with pytest.raises(ValueError, match="transcribe_batch"):
            eng.transcribe(np.stack([wav, wav]))
    finally:
        eng.temperatures = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def test_warmup_runs_both_decode_modes(engines, monkeypatch):
    _, eng, _ = engines
    modes = []
    real = pasr.decode
    monkeypatch.setattr(pasr, "decode", lambda *a, **kw: modes.append(
        (a[1].shape[0], kw["timestamps"])) or real(*a, **kw))
    eng.warmup(batch_sizes=(1, 2))
    assert modes == [(1, False), (1, True), (2, False), (2, True)]


def test_batched_asr_coalesces_concurrent_calls(engines):
    _, eng, _ = engines
    eng.temperatures = (0.0,)
    proxy = BatchedASR(eng, window_ms=200.0)
    try:
        wavs = [_clip(12 + i) for i in range(3)]
        singles = [eng.transcribe(w) for w in wavs]
        out = [None] * 3

        def call(i):
            out[i] = proxy.transcribe(wavs[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert proxy.batcher.batches == 1 and proxy.batcher.items == 3
        assert list(proxy.batcher.batch_log)[0]["size"] == 3
        assert proxy.batcher.batch_log.maxlen == 512
        assert out == singles
        assert proxy.max_tokens == eng.max_tokens          # attr proxy
    finally:
        proxy.batcher.close()
        eng.temperatures = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
