"""Port whisper (``audiogpt_tpu_torch/models/asr/whisper.py``) against the
JAX model on a tiny config with the JAX parameters carried across: the
log-mel frontend, the encoder, the causal decoder forward, the KV-cache
prime and steps, and ``decode`` with every logit filter, greedy and sampled
with JAX's Gumbel draws replayed. Each decode checks the top-2 margin at
every pick, so a near-tie cannot pass or fail by chance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.asr import whisper as jw
from audiogpt_tpu.ops.attention import KVCache as JaxKVCache
from audiogpt_tpu_torch.dsp.mel import mel_filterbank
from audiogpt_tpu_torch.dsp.stft import spectrogram
from audiogpt_tpu_torch.models.asr import whisper as pw
from audiogpt_tpu_torch.ops.attention import KVCache
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(2)

#: the vocab keeps whisper's special, language and timestamp blocks; 1 s
#: windows (100 mel frames, 50 encoder positions)
TINY = dict(n_mels=80, n_audio_ctx=50, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=32, n_text_state=64,
            n_text_head=4, n_text_layer=2, chunk_length=1)
EOT, SOT, NO_SPEECH, LANG_BASE, TS_BEGIN = 50257, 50258, 50362, 50259, 50364
#: the prompts: SOT, language, translate, (no-timestamps)
PROMPT = [SOT, LANG_BASE + 3, 50358, 50363]
TS_PROMPT = PROMPT[:3]
#: every pick's top-2 margin must exceed this: far above the logit
#: difference between the frameworks (~1e-6)
MIN_MARGIN = 1e-3


def random_params(shapes, seed):
    """numpy params for a flax param tree of ``jax.eval_shape`` leaves:
    token embeddings 0.3·N (the tied output projection then spreads the
    logits over units, as a trained whisper's are, so that no two candidates
    tie by chance), other kernels normal · fan_in^-½, LayerNorm scales
    1 + 0.1·N, every other vector 0.1·N."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        a = rng.randn(*s.shape)
        if path[-1].key == "embedding":
            a = 0.3 * a
        elif len(s.shape) >= 2:
            a = a / np.sqrt(np.prod(s.shape[:-1]))
        elif path[-1].key == "scale":
            a = 1.0 + 0.1 * a
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def whisper_params(cfg, seed=0):
    """The JAX model of ``cfg`` and numpy params of its init's shapes."""
    model = jw.WhisperModel(cfg)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 2 * cfg.n_audio_ctx, cfg.n_mels)),
        jnp.zeros((1, 4), jnp.int32))
    return model, random_params(shapes, seed)


def _jit(model, method=None):
    """``model.apply`` (at ``method``) compiled: cheaper than running the
    tiny model op by op."""
    return jax.jit(functools.partial(model.apply, method=method))


@pytest.fixture(scope="module")
def models():
    jm, params = whisper_params(jw.WhisperConfig(**TINY))
    pm = pw.WhisperModel(pw.WhisperConfig(**TINY)).eval()
    load_jax_params(pm, params)
    wav = _wavs(0)
    mel = np.asarray(jw.whisper_log_mel(jnp.asarray(wav)))
    xa = _jit(jm, jw.WhisperModel.encode)(params, jnp.asarray(mel))
    return jm, params, pm, wav, mel, xa


def _wavs(seed, noise=(0.05, 0.1)):
    """Two 1 s rows: a 440 Hz tone over noise, and noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(16000) / 16000.0
    return np.stack([0.3 * np.sin(2 * np.pi * 440.0 * t)
                     + noise[0] * rng.randn(16000),
                     noise[1] * rng.randn(16000)]).astype(np.float32)


def test_log_mel_matches_jax(models):
    _, _, _, wav, mel, _ = models
    got = pw.whisper_log_mel(torch.from_numpy(wav)).numpy()
    assert got.shape == mel.shape == (2, 100, 80)
    np.testing.assert_allclose(got, mel, atol=1e-5, rtol=0)


def test_log_mel_of_a_pure_tone_is_as_close_to_f64_as_jax():
    """A noiseless tone leaves bins seven decades below its peak, just above
    the dynamic-range floor, where each framework's f32 FFT rounding sets
    the value (JAX's is 1.3e-5 from the float64 mel there): the port must
    be as close to the float64 mel as JAX is."""
    wav = _wavs(1, noise=(0.0, 0.1))
    ref = np.asarray(jw.whisper_log_mel(jnp.asarray(wav)))
    got = pw.whisper_log_mel(torch.from_numpy(wav)).numpy()
    # float64 spectrogram, filterbank and log
    power = spectrogram(torch.from_numpy(wav).double(), 400, 160, 400,
                        center=True, pad_mode="reflect",
                        power=2.0)[..., :-1, :].numpy()
    log_spec = np.log10(np.maximum(
        power @ mel_filterbank(16000, 400, 80, 0.0, 8000.0).astype(
            np.float64), 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max(axis=(-2, -1),
                                                 keepdims=True) - 8.0)
    exact = (log_spec + 4.0) / 4.0
    assert np.abs(got - exact).max() <= max(np.abs(ref - exact).max(), 1e-5)


def test_encoder_matches_jax(models):
    jm, params, pm, _, mel, xa = models
    ref = np.asarray(xa)
    with torch.inference_mode():
        got = pm.encode(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 50, 64)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_causal_decoder_forward_matches_jax(models):
    jm, params, pm, _, mel, xa = models
    tokens = np.random.RandomState(1).randint(0, TINY["n_vocab"], (2, 9))
    ref = np.asarray(_jit(jm, lambda m, t, x: m.decoder(t, x))(
        params, jnp.asarray(tokens), xa))
    with torch.inference_mode():
        got = pm(torch.from_numpy(mel), torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_kv_cache_prime_and_steps_match_jax(models):
    """The SOT prompt primed in one call, then 3 single-token steps, each
    through a static cache of 7 positions."""
    jm, params, pm, _, mel, xa = models
    steps = [[11], [2000], [EOT]]
    d = TINY["n_text_state"] // TINY["n_text_head"]
    step = _jit(jm, jw.WhisperModel.decode_step)
    jcaches = [JaxKVCache.create(2, 7, TINY["n_text_head"], d)
               for _ in range(TINY["n_text_layer"])]
    caches = [KVCache.create(2, 7, TINY["n_text_head"], d)
              for _ in range(TINY["n_text_layer"])]
    with torch.inference_mode():
        pxa = pm.decoder.cross_kv(pm.encode(torch.from_numpy(mel)))
        pos = 0
        for chunk in [PROMPT] + steps:
            toks = np.asarray([chunk, chunk])
            ref, jcaches = step(params, jnp.asarray(toks), xa, pos, jcaches)
            got = pm.decode_step(torch.from_numpy(toks), pxa, pos, caches)
            pos += len(chunk)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-4, rtol=0)
            assert caches[0].index == int(jcaches[0].index) == pos
    np.testing.assert_allclose(caches[1].v.numpy(),
                               np.asarray(jcaches[1].v), atol=1e-5, rtol=0)


#: decode option sets: the filters with a vocabulary cut to three text
#: tokens and EOT (so rows finish, and the loop's done check at step 16
#: stops it), and the timestamp mode with the engine's filters
OPTIONS = {
    "filters": dict(
        prompt=PROMPT, max_tokens=20,
        kw=dict(suppress=tuple(i for i in range(EOT)
                               if i not in (10, 11, 12)),
                suppress_gte=EOT + 1, blank_ids=(EOT, 11),
                no_speech_id=NO_SPEECH, lang_range=(LANG_BASE, 99))),
    "timestamps": dict(
        prompt=TS_PROMPT, max_tokens=8,
        kw=dict(suppress=(1, 2, 3), suppress_gte=EOT + 1, blank_ids=(EOT,),
                no_speech_id=NO_SPEECH, lang_range=(LANG_BASE, 99),
                timestamps=True, timestamp_begin=TS_BEGIN)),
}


def _replay_gumbel(rng, b, max_tokens):
    """The draws JAX's decode makes from ``rng``: the first pick's from k0,
    then one per step from ``split(k_rest, max_tokens)``."""
    k0, k_rest = jax.random.split(rng)
    keys = [k0] + list(jax.random.split(k_rest, max_tokens))
    return [torch.from_numpy(np.asarray(jax.random.gumbel(
        k, (b, TINY["n_vocab"]), jnp.float32))) for k in keys]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_decode_matches_jax(models, monkeypatch, option, temperature):
    jm, params, pm, _, mel, xa = models
    opt = OPTIONS[option]
    prompt = np.asarray([opt["prompt"]] * 2)
    rng = jax.random.PRNGKey(7)
    ref = jw.decode(jm, params, jnp.asarray(mel),
                    jnp.asarray(prompt, jnp.int32), opt["max_tokens"], EOT,
                    temperature=temperature, rng=rng, **opt["kw"])
    ref = [np.asarray(r) for r in ref]

    margins = []
    pick = pw._pick

    def recorded(lg, t, g):
        scores = lg / max(t, 1e-6) + g if t > 0 else lg
        top2 = torch.topk(scores, 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).min().item())
        return pick(lg, t, g)

    monkeypatch.setattr(pw, "_pick", recorded)
    noise = (_replay_gumbel(rng, 2, opt["max_tokens"]) if temperature > 0
             else None)
    toks, avg_lp, ns, lang = (t.numpy() for t in pw.decode(
        pm, torch.from_numpy(mel), torch.from_numpy(prompt),
        opt["max_tokens"], EOT, temperature=temperature, noise=noise,
        **opt["kw"]))
    assert min(margins) > MIN_MARGIN
    assert toks.shape == (2, len(opt["prompt"]) + opt["max_tokens"])
    np.testing.assert_array_equal(toks, ref[0])
    for got, want in zip((avg_lp, ns, lang), ref[1:]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert lang.shape == (2, 99) and np.all(avg_lp < 0)
    body = toks[:, len(opt["prompt"]):]
    if option == "filters":
        assert set(body.ravel()) <= {10, 11, 12, EOT}
        assert (body == EOT).any(axis=1).all()  # every row finishes
        if temperature == 0.0:
            # the loop stopped at its step-16 check
            assert len(margins) == 1 + 16
    else:
        assert (body[:, 0] >= TS_BEGIN).all()   # opens with a timestamp

