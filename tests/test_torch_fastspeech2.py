"""Port FastSpeech2 (``audiogpt_tpu_torch/models/tts/fastspeech2.py``)
against the JAX module on shared parameters: inference (``mel2ph``
exact, mel / durations / pitch within 1e-5), the teacher-forced call, the
energy and speaker embeddings, ``predictor_mask_pad`` both ways, a padded
batch of 2; and the f0 and length-regulator helpers.

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
    duration bias set."""
    model = jfs.FastSpeech2(cfg)
    toks = jnp.ones((1, 8), jnp.int32)
    spk = jnp.zeros((1,), jnp.int32) if cfg.num_spk else None
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), toks,
                                               spk_id=spk, infer=True))
    params = jax.tree.map(np.array, _random_params(shapes, seed))
    params["params"]["dur_predictor"]["out"]["bias"][:] = DUR_BIAS
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
    for k in ("mel2ph", "spk_id"):
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
    if "pitch_pred" in ref:
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
            far(ref["pitch_pred"][..., 1], got["pitch_pred"][..., 1],
                lambda x: np.abs(x[valid]), "uv logits")
    if "energy_pred" in ref:
        e = lambda x: x * 64.0
        far(e(ref["energy_pred"]), e(got["energy_pred"]),
            lambda x: np.abs(x - np.round(x)), "energy bins")


VARIANTS = {
    "default": {},
    "reference_predictor_padding": dict(predictor_mask_pad=False),
    "energy_and_speakers": dict(use_energy_embed=True, num_spk=3),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_inference_matches_jax(variant):
    cfg_kw = {**TINY, **VARIANTS[variant]}
    kw = {"spk_id": np.array([1, 3], np.int32)} if "num_spk" in cfg_kw \
        else {}
    toks = tokens(seed=1)
    ref, got = run_both(cfg_kw, toks, **kw)
    assert_margins(ref, got, jfs.FastSpeech2Config(**cfg_kw))
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["mel2ph"], ref["mel2ph"])
    # durations rounded as intended: not all zero, the padded row shorter
    # and whole (row 0 may overrun the canvas and lose its tail, as in JAX)
    frames = (ref["mel2ph"] > 0).sum(1)
    assert 0 < frames[1] < frames[0] <= TINY["max_frames"]
    assert ref["mel2ph"][1].max() == 11
    for key in ("dur", "pitch_pred", "decoder_inp", "mel_out",
                "energy_pred"):
        if key in ref:
            np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0,
                                       err_msg=key)
    # Hz = normalised pitch · f0_std + f0_mean: 1e-5 relative
    np.testing.assert_allclose(got["f0_denorm"], ref["f0_denorm"],
                               rtol=1e-5, atol=ATOL)
    assert np.abs(ref["mel_out"]).max() > 0.1


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
    for kw in (dict(pitch_type="cwt"), dict(use_midi=True),
               dict(rel_pos=True)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            pfs.FastSpeech2(pfs.FastSpeech2Config(**{**TINY, **kw}))
    # the config copies the JAX one field for field, less the two that
    # nothing in the port reads (no dropout; cwt is not ported)
    assert [f.name for f in dataclasses.fields(pfs.FastSpeech2Config)] == \
        [f.name for f in dataclasses.fields(jfs.FastSpeech2Config)
         if f.name not in ("dropout", "cwt_std_scale")]
