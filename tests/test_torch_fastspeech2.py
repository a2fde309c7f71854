"""Port FastSpeech2 (``audiogpt_tpu_torch/models/tts/fastspeech2.py``)
against the JAX module on shared parameters: inference (``mel2ph``
exact, mel / durations / pitch within 1e-5), the teacher-forced call, the
energy and speaker embeddings, ``predictor_mask_pad`` both ways,
DiffSinger's ``use_midi`` and ``rel_pos`` encoders, the ``cwt`` pitch
branch, a padded batch of 2; and the f0 and length-regulator helpers.

Durations go through ``round(exp(d) − 1)``, pitch through ``rint`` and uv
through a sign test, so a difference of one ulp between the frameworks
could move a frame. Every test asserts that each rounded value lies more
than 10× the frameworks' difference from its rounding boundary (and each
uv logit from 0), so equality of the rounded outputs is a fair check."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.tts import fastspeech2 as jfs
from audiogpt_tpu_torch.models.tts import fastspeech2 as pfs
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_bigvgan import _random_params

torch.set_num_threads(2)

#: f32 through a few layers on shared weights, summed in other orders
ATOL = 1e-5
#: the duration predictor's output bias: exp(1.8) − 1 ≈ 5 frames a phone,
#: so durations are not all rounded to zero
DUR_BIAS = 1.8

TINY = dict(vocab_size=40, hidden_size=32, enc_layers=1, dec_layers=1,
            num_heads=2, dur_predictor_layers=2, predictor_layers=2,
            max_frames=128)


def fs2_params(cfg: jfs.FastSpeech2Config, seed: int = 0) -> dict:
    """numpy params of the JAX module (from ``jax.eval_shape``) with the
    duration bias set; with ``cwt``, the utterance statistics' output
    scaled by 1e-2 with a bias of log-f0 mean log(200) and std 0.3125
    (· ``cwt_std_scale`` = 0.25), so the f0 lies in the voice's range."""
    model = jfs.FastSpeech2(cfg)
    toks = jnp.ones((1, 8), jnp.int32)
    spk = jnp.zeros((1,), jnp.int32) if cfg.num_spk else None
    midi = dict(pitch_midi=toks, midi_dur=jnp.ones((1, 8)),
                is_slur=toks * 0) if cfg.use_midi else {}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), toks,
                                               spk_id=spk, infer=True,
                                               **midi))
    params = jax.tree.map(np.array, _random_params(shapes, seed))
    params["params"]["dur_predictor"]["out"]["bias"][:] = DUR_BIAS
    if cfg.pitch_type == "cwt" and cfg.use_pitch_embed:
        stats = params["params"]["cwt_stats"]
        stats["kernel"] *= 1e-2
        stats["bias"][:] = (np.log(200.0), 0.3125)
    return params


def tokens(seed: int = 0, batch: int = 2, length: int = 16) -> np.ndarray:
    """Token ids with row 1 padded after 11 tokens."""
    toks = np.random.RandomState(seed).randint(1, TINY["vocab_size"],
                                               (batch, length))
    if batch > 1:
        toks[1, 11:] = 0
    return toks.astype(np.int32)


def run_both(cfg_kw: dict, toks: np.ndarray, seed: int = 0, **kw):
    """(JAX outputs, port outputs) as numpy dicts on the same params."""
    jcfg = jfs.FastSpeech2Config(**cfg_kw)
    params = fs2_params(jcfg, seed)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    # jitted: flax's op-by-op dispatch costs more than one compile
    ref = jax.jit(lambda p, t, kw: jfs.FastSpeech2(jcfg).apply(
        p, t, infer=True, **kw))(params, jnp.asarray(toks), jkw)
    model = pfs.FastSpeech2(pfs.FastSpeech2Config(**cfg_kw))
    load_jax_params(model, params)
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
    for k in ("mel2ph", "spk_id", "pitch_midi", "is_slur"):
        if k in tkw:
            tkw[k] = tkw[k].long()
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long(), **tkw)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


def assert_margins(ref: dict, got: dict, cfg: jfs.FastSpeech2Config,
                   predicted: bool = True) -> None:
    """Every rounded quantity lies more than 10× the frameworks' difference
    from its rounding boundary."""
    def far(x_ref, x_got, boundary_dist, what):
        diff = max(float(np.abs(x_ref - x_got).max()), 1e-7)
        dist = boundary_dist(x_ref)
        assert dist.size == 0 or dist.min() > 10 * diff, \
            f"{what}: margin {dist.min()} vs difference {diff}"

    def half(x):      # distance from the round-half boundaries
        return np.abs(np.abs(x - np.floor(x)) - 0.5)

    if predicted:
        d_ref, d_got = np.exp(ref["dur"]) - 1, np.exp(got["dur"]) - 1
        live = d_ref > 0          # round(x ≤ 0) clips to 0 either way
        far(d_ref, d_got, lambda x: half(x[live]), "durations")
    if "f0_denorm" in ref:
        voiced = ref["f0_denorm"] > 0

        def coarse(f0):
            mel = 1127.0 * np.log(1.0 + f0 / 700.0)
            return (mel - jfs.F0_MEL_MIN) * (jfs.F0_BIN - 2) \
                / (jfs.F0_MEL_MAX - jfs.F0_MEL_MIN) + 1.0

        s_ref, s_got = coarse(ref["f0_denorm"]), coarse(got["f0_denorm"])
        inside = voiced & (s_ref > 1.0) & (s_ref < jfs.F0_BIN - 1)
        far(s_ref, s_got, lambda x: half(x[inside]), "coarse pitch")
        if cfg.use_uv and predicted:
            # on the canvas's padding the f0 is zeroed whatever uv says
            valid = ref["mel2ph"] > 0
            uv = ("cwt", -1) if "cwt" in ref else ("pitch_pred", 1)
            far(ref[uv[0]][..., uv[1]], got[uv[0]][..., uv[1]],
                lambda x: np.abs(x[valid]), "uv logits")
    if "energy_pred" in ref:
        e = lambda x: x * 64.0
        far(e(ref["energy_pred"]), e(got["energy_pred"]),
            lambda x: np.abs(x - np.round(x)), "energy bins")


VARIANTS = {
    "default": {},
    "reference_predictor_padding": dict(predictor_mask_pad=False),
    "energy_and_speakers": dict(use_energy_embed=True, num_spk=3),
    # DiffSinger's encoder inputs (svs/diffsinger.py:45)
    "use_midi": dict(use_midi=True),
    "rel_pos": dict(rel_pos=True),
    "cwt": dict(pitch_type="cwt"),
}
#: the cwt tree's leaves come in another order, so seed 0's durations
#: differ; seed 3 keeps the padded row the shorter one
SEEDS = {"cwt": 3}


def variant_inputs(cfg_kw: dict) -> dict:
    """The variant's extra inputs: speaker ids, or a MIDI score (notes,
    durations in seconds and slur flags) for the tokens' batch of 2."""
    if "num_spk" in cfg_kw:
        return {"spk_id": np.array([1, 3], np.int32)}
    if cfg_kw.get("use_midi"):
        rng = np.random.RandomState(4)
        return {"pitch_midi": rng.randint(48, 84, (2, 16)).astype(np.int32),
                "midi_dur": rng.uniform(0.05, 0.6, (2, 16)).astype(
                    np.float32),
                "is_slur": rng.randint(0, 2, (2, 16)).astype(np.int32)}
    return {}


@pytest.mark.parametrize("variant", VARIANTS)
def test_inference_matches_jax(variant):
    cfg_kw = {**TINY, **VARIANTS[variant]}
    kw = variant_inputs(cfg_kw)
    toks = tokens(seed=1)
    ref, got = run_both(cfg_kw, toks, seed=SEEDS.get(variant, 0), **kw)
    assert_margins(ref, got, jfs.FastSpeech2Config(**cfg_kw))
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["mel2ph"], ref["mel2ph"])
    # durations rounded as intended: not all zero, the padded row shorter
    # and whole (row 0 may overrun the canvas and lose its tail, as in JAX)
    frames = (ref["mel2ph"] > 0).sum(1)
    assert 0 < frames[1] < frames[0] <= TINY["max_frames"]
    assert ref["mel2ph"][1].max() == 11
    for key in ("dur", "pitch_pred", "decoder_inp", "mel_out",
                "energy_pred", "cwt", "f0_mean", "f0_std"):
        if key in ref:
            np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0,
                                       err_msg=key)
    # Hz = normalised pitch · f0_std + f0_mean: 1e-5 relative
    np.testing.assert_allclose(got["f0_denorm"], ref["f0_denorm"],
                               rtol=1e-5, atol=ATOL)
    assert np.abs(ref["mel_out"]).max() > 0.1
    if variant == "cwt":
        # the cwt f0 lies in the voice's range and spans several bins
        f0 = ref["f0_denorm"][ref["f0_denorm"] > 0]
        bins = np.unique(pfs.f0_to_coarse(torch.from_numpy(f0)).numpy())
        assert 80 < f0.min() and f0.max() < 600 and len(bins) > 5


def test_branch_inputs_move_the_output():
    """``use_midi`` and ``rel_pos`` change the encoder, so neither parity
    case above is vacuous: the same tokens and weights without the MIDI
    inputs, or with fairseq's positions, give another mel."""
    toks = tokens(seed=1)
    cfg_kw = {**TINY, **VARIANTS["use_midi"]}
    params = fs2_params(jfs.FastSpeech2Config(**cfg_kw))
    model = pfs.FastSpeech2(pfs.FastSpeech2Config(**cfg_kw))
    load_jax_params(model, params)
    midi = {k: torch.from_numpy(v) for k, v in
            variant_inputs(cfg_kw).items()}
    mel2ph = torch.from_numpy(np.repeat(np.arange(1, 17), 5)[None]
                              .repeat(2, 0).astype(np.int64))
    with torch.no_grad():
        plain = model(torch.from_numpy(toks).long(), mel2ph=mel2ph)
        with_midi = model(torch.from_numpy(toks).long(), mel2ph=mel2ph,
                          pitch_midi=midi["pitch_midi"].long(),
                          midi_dur=midi["midi_dur"],
                          is_slur=midi["is_slur"].long())
        model.cfg = pfs.FastSpeech2Config(**{**cfg_kw, "rel_pos": True})
        rel = model(torch.from_numpy(toks).long(), mel2ph=mel2ph)
    for other in (with_midi, rel):
        assert (other["mel_out"] - plain["mel_out"]).abs().max() > 0.1


def test_teacher_forced_call_matches_jax():
    """Ground-truth mel2ph, f0 (normalised) and uv: no duration or uv
    rounding; the pitch embedding and decoder follow the given values."""
    toks = tokens(seed=2)
    rng = np.random.RandomState(5)
    mel2ph = np.zeros((2, TINY["max_frames"]), np.int32)
    mel2ph[0, :96] = np.repeat(np.arange(1, 17), 6)
    mel2ph[1, :55] = np.repeat(np.arange(1, 12), 5)
    f0 = rng.randn(2, TINY["max_frames"]).astype(np.float32)
    uv = (rng.rand(2, TINY["max_frames"]) > 0.7).astype(np.float32)
    ref, got = run_both(TINY, toks, mel2ph=mel2ph, f0=f0, uv=uv)
    assert_margins(ref, got, jfs.FastSpeech2Config(**TINY), predicted=False)
    np.testing.assert_array_equal(got["mel2ph"], mel2ph)
    for key in ("dur", "pitch_pred", "decoder_inp", "mel_out"):
        np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(got["f0_denorm"], ref["f0_denorm"],
                               rtol=1e-5, atol=ATOL)
    assert (got["f0_denorm"][uv > 0] == 0).all()


def test_helpers_match_jax():
    rng = np.random.RandomState(3)
    f0 = np.concatenate([np.zeros(4), rng.uniform(30, 1300, 200)]).astype(
        np.float32)
    np.testing.assert_array_equal(
        pfs.f0_to_coarse(torch.from_numpy(f0)).numpy(),
        np.asarray(jfs.f0_to_coarse(jnp.asarray(f0))))
    dur = rng.randint(0, 6, (2, 12)).astype(np.float32)
    dur[1, 8:] = 0
    for frames, alpha in ((64, 1.0), (20, 1.0), (64, 1.3)):   # 20: the cut
        np.testing.assert_array_equal(
            pfs.length_regulator(torch.from_numpy(dur), frames, alpha).numpy(),
            np.asarray(jfs.length_regulator(jnp.asarray(dur), frames, alpha)))
    uv = (rng.rand(200) > 0.5).astype(np.float32)
    x = rng.randn(200).astype(np.float32)
    for norm in ("standard", "log"):
        cfg = jfs.FastSpeech2Config(pitch_norm=norm)
        pcfg = pfs.FastSpeech2Config(pitch_norm=norm)
        pad = np.arange(200) > 180
        np.testing.assert_allclose(
            pfs.denorm_f0(torch.from_numpy(x), torch.from_numpy(uv), pcfg,
                          torch.from_numpy(pad)).numpy(),
            np.asarray(jfs.denorm_f0(jnp.asarray(x), jnp.asarray(uv), cfg,
                                     jnp.asarray(pad))), rtol=1e-6)
        np.testing.assert_allclose(
            pfs.norm_f0(torch.from_numpy(np.abs(x) * 200), torch.from_numpy(
                uv), pcfg).numpy(),
            np.asarray(jfs.norm_f0(jnp.asarray(np.abs(x) * 200),
                                   jnp.asarray(uv), cfg)), rtol=1e-6)
    np.testing.assert_array_equal(pfs.sinusoid_table(50, 33),
                                  jfs.sinusoid_table(50, 33))


def test_unported_branches_raise():
    """Every branch is ported: each of them builds, and the config copies
    the JAX one field for field, less ``dropout`` (the port runs inference
    only)."""
    for kw in (dict(pitch_type="cwt"), dict(use_midi=True),
               dict(rel_pos=True)):
        pfs.FastSpeech2(pfs.FastSpeech2Config(**{**TINY, **kw}))
    assert [f.name for f in dataclasses.fields(pfs.FastSpeech2Config)] == \
        [f.name for f in dataclasses.fields(jfs.FastSpeech2Config)
         if f.name != "dropout"]
