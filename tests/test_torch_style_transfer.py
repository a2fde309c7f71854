"""Port GenerSpeech as a whole and ``StyleTransferEngine``
(``audiogpt_tpu_torch/engines/tts_ood.py``) against the JAX package on
shared parameters (``test_torch_generspeech.gs_params``: every
zero-initialised layer filled, orthogonal 1×1s, durations and pitch held
mid-way between rounding edges) and replayed draws, through one compiled
JAX program: the model with the post-flow on, the engine on a tiny config
(the reference's log-mel, the post-flow, the vocoder's mono wav), and the
engine's departure from JAX on a long reference (cut to the largest
bucket, where JAX raises). Each uv logit is checked to lie more than 10×
the frameworks' difference from 0. Tolerances: model outputs within 1e-4
absolute, the sampled mel and the wav within 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines import tts_ood as jtts_ood
from audiogpt_tpu.engines.vocoder import VocoderEngine as JaxVocoderEngine
from audiogpt_tpu.models.vocoder import hifigan as jh
from audiogpt_tpu_torch.engines import tts_ood
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.vocoder import hifigan as ph
from test_torch_generspeech import (DUR_FRAMES, FS2, MELS, REF_FRAMES,
                                    TOKENS, configs, gs_params, ref_mel)
from test_torch_svs import ATOL, SAMPLE_ATOL, init_params, to_torch

torch.set_num_threads(2)

HIFI = dict(in_channels=MELS, upsample_initial_channel=16,
            upsample_rates=(16,), upsample_kernel_sizes=(32,),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
TEXT = "Hello world."


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, params): shared GenerSpeech and HiFi-GAN
    parameters, one token and one reference bucket."""
    jcfg, pcfg = configs()
    params = gs_params(jcfg, seed=20)
    vparams = init_params(jh.HifiGANGenerator(jh.HifiGANConfig(**HIFI)),
                          jnp.zeros((1, 16, MELS)), seed=21)
    jeng = jtts_ood.StyleTransferEngine(
        jcfg, params=params,
        vocoder=JaxVocoderEngine("hifigan", cfg=jh.HifiGANConfig(**HIFI),
                                 params=vparams, buckets=(64,)),
        token_buckets=(TOKENS,), ref_frame_buckets=(REF_FRAMES,))
    eng = tts_ood.StyleTransferEngine(
        pcfg, params=params,
        vocoder=VocoderEngine("hifigan", cfg=ph.HifiGANConfig(**HIFI),
                              params=vparams, buckets=(64,), device="cpu"),
        token_buckets=(TOKENS,), ref_frame_buckets=(REF_FRAMES,),
        device="cpu")
    return jeng, eng, params


def far_from_zero(ref, got, what):
    diff = max(float(np.abs(np.asarray(ref) - got).max()), 1e-7)
    assert np.abs(ref).min() > 10 * diff, f"{what}: {np.abs(ref).min()} " \
                                          f"vs difference {diff}"


def test_generspeech_matches_jax(engines):
    """The whole model, post-flow on, through the JAX engine's compiled
    ``GenerSpeech.apply`` (tokens and reference at the engine's buckets)
    with the post-flow's draw replayed."""
    jeng, eng, params = engines
    toks = np.zeros((1, TOKENS), np.int32)
    toks[0, :19] = np.random.RandomState(7).randint(3, 80, 19)
    mel = ref_mel(50, seed=8)
    key = jax.random.PRNGKey(9)
    ref = jeng._fn(params, toks, mel, key, True)
    z = jax.random.normal(jax.random.split(key)[1],
                          (1, FS2["max_frames"] // 2, 2 * MELS))
    with torch.no_grad():
        got = eng.model(to_torch(toks).long(), to_torch(mel),
                        draws=to_torch(z))
    far_from_zero(np.asarray(ref["pitch_pred"])[0, :57, 1],
                  got["pitch_pred"].numpy()[0, :57, 1], "uv logits")
    np.testing.assert_array_equal(got["mel2ph"].numpy(), ref["mel2ph"])
    assert int((ref["mel2ph"] > 0).sum()) == 19 * DUR_FRAMES
    for k in ("dur", "pitch_pred", "decoder_inp"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], atol=ATOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(got["mel_out"].numpy(), ref["mel_out"],
                               atol=SAMPLE_ATOL, rtol=0)
    assert np.abs(ref["mel_out"]).max() > 0.1


def speech_ref(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 22050)) / 22050
    return (0.3 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t)
            + 0.02 * rng.randn(t.size)).astype(np.float32)


def test_style_transfer_engine_matches_jax(engines):
    """``synthesize`` with the JAX engine's first-call draw replayed: the
    reference's log-mel on the 64-frame bucket, the mel through the
    post-flow, and the vocoder's mono wav."""
    jeng, eng, _ = engines
    wav = speech_ref(0.6)                          # 52 reference frames
    jeng._rng = jax.random.PRNGKey(0)
    ref = jeng.synthesize(TEXT, wav)
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    z = jax.random.normal(jax.random.split(rng)[1],
                          (1, FS2["max_frames"] // 2, 2 * MELS))
    got = eng.synthesize(TEXT, wav, draws=to_torch(z))
    n = len(eng.frontend.encode(TEXT))
    assert got.dtype == np.float32 and got.ndim == 1
    assert got.shape == ref.shape == (n * DUR_FRAMES * 16,)
    assert np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, atol=SAMPLE_ATOL, rtol=0)
    assert eng.sample_rate == jeng.sample_rate == 22050


def test_long_reference_is_cut_not_refused(engines):
    """A reference past the largest frame bucket raises in JAX; the port
    takes its first 64 frames (the same mel as the reference cut there),
    and a reference JAX accepts is read unchanged."""
    jeng, eng, _ = engines
    long_wav = speech_ref(2.0, seed=1)              # 173 frames
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        jeng.synthesize(TEXT, long_wav)
    cut = eng.ref_mel(long_wav)
    assert cut.shape == (1, REF_FRAMES, MELS)
    head = eng.ref_mel(long_wav[:(REF_FRAMES - 1) * 256])
    np.testing.assert_array_equal(cut[0, :REF_FRAMES - 2].numpy(),
                                  head[0, :REF_FRAMES - 2].numpy())
    wav = eng.synthesize(TEXT, long_wav)
    assert wav.ndim == 1 and np.isfinite(wav).all() and wav.std() > 0
