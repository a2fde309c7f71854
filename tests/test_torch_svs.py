"""Port SVS (``audiogpt_tpu_torch/engines/svs.py``, ``models/svs/``,
``models/tts/pitch_extractor.py``, the samplers of
``models/diffusion/samplers.py``) against the JAX package on shared
parameters and replayed draws: the score helpers exactly, ``DiffNet``,
``plms_interval_sample`` on an analytic eps, ``DiffSinger``,
``PitchExtractor`` and ``SVSEngine`` (PLMS and DDPM) on a tiny config.
``ddpm_sample`` and the cosine schedule are in ``test_torch_diffusion.py``,
VISinger in ``test_torch_visinger.py``.

Every layer that JAX zero-initialises (``DiffNet.output_projection``) gets
random values on both sides (``_random_params``), or the comparison would
show nothing. The duration predictor's output weights are scaled by 1e-3
and its bias puts every phone mid-way between two frame counts, so no
rounded duration sits near its rounding edge.

Tolerances: module outputs within 1e-4 absolute (f32 through a few layers
on shared weights), the sampled mel and the wav within 5e-4 (a few sampler
steps, each rescaling the last one's difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines import svs as jsvs
from audiogpt_tpu.engines.vocoder import VocoderEngine as JaxVocoderEngine
from audiogpt_tpu.models.svs import diffsinger as jds
from audiogpt_tpu.models.tts import fastspeech2 as jfs
from audiogpt_tpu.models.tts import pitch_extractor as jpe
from audiogpt_tpu.models.vocoder import hifigan as jh
from audiogpt_tpu.text import zh as jzh
from audiogpt_tpu_torch.engines import svs
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.svs import diffsinger as pds
from audiogpt_tpu_torch.models.tts import FastSpeech2Config
from audiogpt_tpu_torch.models.tts import pitch_extractor as ppe
from audiogpt_tpu_torch.models.vocoder import hifigan as ph
from audiogpt_tpu_torch.text import zh as pzh
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_bigvgan import _random_params
from test_torch_diffusion import eps_frames, frames_inputs

torch.set_num_threads(2)

#: module outputs: f32 through a few layers on shared weights
ATOL = 1e-4
#: the sampled mel and the wav, after a few sampler steps
SAMPLE_ATOL = 5e-4
#: exp(d) − 1 = 3.0 frames a phone, mid-way between the rounding edges
#: 2.5 and 3.5
DUR_FRAMES = 3.0

#: a short opencpop-style score: a slur (two notes on "hao"), SP and AP
SONG = ("ni hao SP shi jie AP",
        "C4 | D4 E4 | rest | F#4/Gb4 | G4 | rest",
        "0.1 | 0.3 0.2 | 0.25 | 0.2 | 0.15 | 0.3")
MELS = 16
FS2 = dict(vocab_size=64, hidden_size=16, enc_layers=1, dec_layers=1,
           num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
           n_mels=MELS, use_midi=True, rel_pos=True, use_pitch_embed=False,
           predictor_hidden=8, predictor_layers=1, max_frames=64)
#: DiffSinger's denoiser: one residual layer (the JAX samplers compile it
#: twice, in the PLMS warm-up branch and the step); the DiffNet test takes
#: three, dilations 1, 2, 1
NET = dict(mel_bins=MELS, encoder_hidden=16, residual_layers=1,
           residual_channels=8, dilation_cycle_length=2)
NET_DEEP = dict(NET, residual_layers=3)
#: PLMS at the app's step interval: 4 steps and the warm-up's extra eval
PLMS = dict(timesteps=40, K_step=40, max_beta=0.06)
#: DDPM over a few steps
DDPM = dict(timesteps=6, K_step=6, max_beta=0.3)
HIFI = dict(in_channels=MELS, upsample_initial_channel=16,
            upsample_rates=(16,), upsample_kernel_sizes=(32,),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))


def ds_configs(**kw):
    spec = dict(spec_min=(-6.0,) * MELS, spec_max=(1.5,) * MELS)
    return (jds.DiffSingerConfig(fs2=jfs.FastSpeech2Config(**FS2),
                                 net=jds.DiffNetConfig(**NET), **spec, **kw),
            pds.DiffSingerConfig(fs2=FastSpeech2Config(**FS2),
                                 net=pds.DiffNetConfig(**NET), **spec, **kw))


def set_durations(dur_out: dict) -> None:
    """The duration head's output: weights · 1e-3, bias for DUR_FRAMES."""
    dur_out["kernel"] *= 1e-3
    dur_out["bias"][:] = np.log(DUR_FRAMES + 1.0)


def init_params(module, *args, seed: int = 0, **kw) -> dict:
    """numpy params of a flax module from ``jax.eval_shape`` (no compiled
    init), every leaf random (``test_torch_bigvgan._random_params``)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kw))
    return jax.tree.map(np.array, _random_params(shapes, seed))


def diffsinger_params(jcfg, seed: int) -> dict:
    toks = jnp.ones((1, 4), jnp.int32)
    params = init_params(jds.DiffSinger(jcfg), toks,
                         pitch_midi=toks, midi_dur=jnp.ones((1, 4)),
                         is_slur=toks * 0, seed=seed)
    set_durations(params["params"]["fs2"]["dur_predictor"]["out"])
    return params


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("syllable", ["xiao3", "ai4", "zhang", "shi",
                                      "er2", "a", "ch1", "ZHONG1", " wo "])
def test_split_pinyin_matches_jax(syllable):
    assert pzh.split_pinyin(syllable) == jzh.split_pinyin(syllable)
    assert pzh.INITIALS == jzh.INITIALS


@pytest.mark.parametrize("note", ["C4", "C#4/Db4", "D#4/Eb4", "Bb3", "a5",
                                  "E♭4", "F♯2", "C-1", "rest", "", "H4"])
def test_note_to_midi_matches_jax(note):
    assert svs.note_to_midi(note) == jsvs.note_to_midi(note)


SCORES = {
    "song": SONG,
    "slurs": ("wo ai ni", "C4 D4 E4 | F4 | G4 A4",
              "0.1 0.2 0.3 | 0.4 | 0.5 0.6"),
    "breath_and_rest": ("SP la AP rest", "rest | A4 | rest | rest",
                        "0.2 | 0.3 | 0.1 | 0.4"),
    "table": ("ni hao", "C4 | D4", "0.1 | 0.2"),
}


@pytest.mark.parametrize("case", SCORES)
def test_parse_score_matches_jax(case):
    table = {"hao": "h ao", "ni": "n i"} if case == "table" else None
    assert svs.parse_score(*SCORES[case], table) == \
        jsvs.parse_score(*SCORES[case], table)
    assert svs._default_svs_vocab() == jsvs._default_svs_vocab()


def test_parse_score_refuses_mismatched_windows():
    for args in (("ni hao", "C4", "0.1 | 0.2"),
                 ("ni", "C4 | D4", "0.1 | 0.2")):
        with pytest.raises(ValueError, match="window counts differ"):
            svs.parse_score(*args)
        with pytest.raises(ValueError, match="window counts differ"):
            jsvs.parse_score(*args)


# ---------------------------------------------------------------------------
# schedules, samplers, DiffNet
# ---------------------------------------------------------------------------


def test_diffnet_matches_jax():
    jnet, pnet = jds.DiffNet(jds.DiffNetConfig(**NET_DEEP)), \
        pds.DiffNet(pds.DiffNetConfig(**NET_DEEP))
    rng = np.random.RandomState(0)
    spec = rng.randn(2, 12, MELS).astype(np.float32)
    t = np.array([5, 37], np.int32)
    cond = rng.randn(2, 12, NET["encoder_hidden"]).astype(np.float32)
    params = init_params(jnet, spec, t, cond, seed=1)
    assert np.abs(params["params"]["output_projection"]["kernel"]).max() > 0
    ref = np.asarray(jax.jit(jnet.apply)(params, spec, t, cond))
    load_jax_params(pnet, params)
    with torch.no_grad():
        got = pnet(to_torch(spec), to_torch(t), to_torch(cond)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_plms_interval_sample_matches_jax():
    """K_step 40 at interval 10: timesteps 30, 20, 10, 0 and the warm-up's
    extra eval at the first."""
    sched = jds.DiffSingerConfig(**PLMS).schedule()
    x, cond = frames_inputs()
    ref = np.asarray(jax.jit(lambda x, c: jds.plms_interval_sample(
        eps_frames(jnp), sched, x, c, 40, 10))(x, cond))
    calls = []

    def eps(x, t, c):
        calls.append(int(t[0]))
        return eps_frames(torch)(x, t, c)

    got = pds.plms_interval_sample(eps, pds.DiffSingerConfig(
        **PLMS).schedule(), to_torch(x), to_torch(cond), 40, 10).numpy()
    assert calls == [30, 20, 20, 10, 0]
    assert np.abs(ref - x).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=SAMPLE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# DiffSinger, the SVS engine, PitchExtractor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vocoders():
    """The JAX and port engines of one tiny HiFi-GAN on a 16-bin mel (one
    compiled JAX program for every test)."""
    vparams = init_params(jh.HifiGANGenerator(jh.HifiGANConfig(**HIFI)),
                          jnp.zeros((1, 16, MELS)), seed=11)
    return (JaxVocoderEngine("hifigan", cfg=jh.HifiGANConfig(**HIFI),
                             params=vparams, buckets=(64,)),
            VocoderEngine("hifigan", cfg=ph.HifiGANConfig(**HIFI),
                          params=vparams, buckets=(64,), device="cpu"))


SAMPLERS = {
    # the app's sampler: PLMS at step 10 from a Gaussian start
    "plms": dict(steps=PLMS, speedup=10, gaussian_start=True),
    # DDPM from q_sample of the FS2 mel
    "ddpm": dict(steps=DDPM, speedup=1, gaussian_start=False),
}


@pytest.fixture(scope="module", params=list(SAMPLERS))
def engines(request, vocoders):
    """(sampler, JAX engine, port engine) on shared parameters."""
    kw = SAMPLERS[request.param]
    jcfg, pcfg = ds_configs(**kw["steps"],
                            gaussian_start=kw["gaussian_start"])
    params = diffsinger_params(jcfg, seed=10)
    jvoc, voc = vocoders
    return (request.param,
            jsvs.SVSEngine(jcfg, params=params, vocoder=jvoc,
                           token_buckets=(16,), pndm_speedup=kw["speedup"]),
            svs.SVSEngine(pcfg, params=params, vocoder=voc,
                          token_buckets=(16,), pndm_speedup=kw["speedup"],
                          device="cpu"))


def replayed_draws(key, cfg) -> tuple:
    """The draws of DiffSinger's ``rng``: x_T from the second key of its
    three-way split, DDPM's per-step noise from the third."""
    _, k1, k2 = jax.random.split(key, 3)
    shape = (1, cfg.fs2.max_frames, cfg.net.mel_bins)
    keys = jax.random.split(jax.random.split(k2)[0], cfg.K_step)
    return (to_torch(jax.random.normal(k1, shape)),
            [to_torch(jax.random.normal(k, shape)) for k in keys])


def _score(seed=0):
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = np.random.RandomState(seed).randint(3, 60, 11)
    midi = np.where(toks > 0, 60 + np.arange(16) % 7, 0).astype(np.int32)
    dur = np.where(toks > 0, 0.1 + 0.05 * (np.arange(16) % 3), 0).astype(
        np.float32)
    slur = np.where(toks > 0, np.arange(16) % 4 == 3, 0).astype(np.int32)
    return toks, midi, dur, slur


def test_diffsinger_matches_jax(engines):
    """The module on a random score, through the JAX engine's compiled
    ``DiffSinger.apply`` and the port's module, with JAX's draws replayed:
    PLMS from a Gaussian start; DDPM from q_sample of the FS2 mel."""
    sampler, jeng, eng = engines
    toks, midi, dur, slur = _score()
    key = jax.random.PRNGKey(7)
    ref = jeng._fn(jeng.params, toks, midi, dur, slur, key)
    with torch.no_grad():
        got = eng.model(to_torch(toks).long(), to_torch(midi).long(),
                        to_torch(dur), to_torch(slur).long(),
                        draws=replayed_draws(key, eng.cfg),
                        pndm_speedup=eng.pndm_speedup)
    np.testing.assert_array_equal(got["mel2ph"].numpy(), ref["mel2ph"])
    frames = int((ref["mel2ph"] > 0).sum())
    assert frames == 11 * DUR_FRAMES
    assert got["f0_denorm"] is None and ref["f0_denorm"] is None
    np.testing.assert_allclose(got["fs2_mel"].numpy(), ref["fs2_mel"],
                               atol=ATOL, rtol=0)
    mel = got["mel_out"].numpy()
    assert (mel[0, frames:] == 0).all() and np.abs(mel[0, :frames]).min() > 0
    np.testing.assert_allclose(mel, ref["mel_out"], atol=SAMPLE_ATOL, rtol=0)


def test_svs_engine_matches_jax(engines):
    """``synthesize`` on the score, with the draws of the JAX engine's
    first call replayed (its key split, then the model's)."""
    sampler, jeng, eng = engines
    jeng._rng = jax.random.PRNGKey(0)
    ref = jeng.synthesize(*SONG)
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    got = eng.synthesize(*SONG, draws=replayed_draws(rng, eng.cfg))
    n_phones = len(svs.parse_word_level(*SONG)[0])
    assert n_phones == 11
    assert got.dtype == np.float32
    assert got.shape == ref.shape == (n_phones * DUR_FRAMES * 16,)
    assert np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, atol=SAMPLE_ATOL, rtol=0)
    assert eng.sample_rate == jeng.sample_rate == 22050


def test_pitch_extractor_matches_jax():
    kw = dict(n_mels=MELS, hidden=16, prenet_layers=2, conv_layers=1,
              predictor_layers=1)
    jmod = jpe.PitchExtractor(jpe.PitchExtractorConfig(**kw))
    mel = np.random.RandomState(4).randn(2, 24, MELS).astype(np.float32)
    mel[1, 17:] = 0.0                          # padding frames
    params = init_params(jmod, mel, seed=5)
    out = params["params"]["pitch_predictor"]["out"]
    out["kernel"][:, 0] *= 1e-3              # f0 inside one coarse bin...
    out["bias"][0] = 0.3                     # ...at 218 Hz
    ref = jax.jit(jmod.apply)(params, mel)
    pmod = ppe.PitchExtractor(ppe.PitchExtractorConfig(**kw))
    load_jax_params(pmod, params)
    with torch.no_grad():
        got = pmod(to_torch(mel))
    # no uv logit of a valid frame within 10× the difference of 0
    uv = np.asarray(ref["pitch_pred"])[..., 1]
    valid = np.abs(mel).sum(-1) > 0
    assert np.abs(uv[valid]).min() > 10 * np.abs(
        got["pitch_pred"].numpy()[..., 1] - uv).max()
    np.testing.assert_allclose(got["pitch_pred"].numpy(), ref["pitch_pred"],
                               atol=ATOL, rtol=0)
    # Hz = normalised pitch · 60 + 200
    np.testing.assert_allclose(got["f0_denorm_pred"].numpy(),
                               ref["f0_denorm_pred"], atol=ATOL * 60,
                               rtol=0)
    assert (got["f0_denorm_pred"].numpy()[1, 17:] == 0).all()


def test_svs_engine_pitch_extractor_pads_onto_the_vocoder_bucket(vocoders):
    """Without a model f0 the pitch extractor runs on the trimmed mel padded
    onto the vocoder's bucket, as in JAX: its f0 on the valid frames is the
    one it gives the unpadded mel (the extractor masks padding)."""
    _, pcfg = ds_configs(**PLMS)
    pe = ppe.PitchExtractor(ppe.PitchExtractorConfig(n_mels=MELS, hidden=8,
                                                     predictor_layers=1))
    eng = svs.SVSEngine(pcfg, vocoder=vocoders[1], pitch_extractor=pe,
                        token_buckets=(16,), device="cpu")
    mel, f0 = eng.synthesize_mel(*SONG)
    with torch.no_grad():
        alone = pe(mel[None])["f0_denorm_pred"][0]
    assert mel.shape[0] < 64 and f0.shape == (mel.shape[0],)
    np.testing.assert_allclose(f0.numpy(), alone.numpy(), atol=1e-3)
