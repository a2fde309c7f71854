"""Port ``I2AEngine`` (``audiogpt_tpu_torch/engines/i2a.py``) against the
JAX engine: a tiny T2A engine (``test_torch_t2a``'s configs) and tiny CLIP
towers (``tests/test_i2a.py``'s) on shared parameters. The image context,
the ``""`` unconditional embedding, and the DDIM core with the CFG pair on
the same initial noise; then the engine's own call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.i2a import I2AEngine as JaxI2AEngine
from audiogpt_tpu.models.textenc import clip as jclip
from audiogpt_tpu_torch.engines import I2AEngine
from audiogpt_tpu_torch.models.textenc import clip as pclip
from test_torch_t2a import _random_params, engines  # noqa: F401

torch.set_num_threads(2)

VISION = dict(image_size=32, patch_size=8, width=16, layers=1, heads=2,
              embed_dim=32)
TEXT = dict(vocab_size=100, context_length=16, width=16, layers=1, heads=2,
            embed_dim=32)
STEPS = 5


@pytest.fixture(scope="module")
def i2a(engines):  # noqa: F811
    jeng, eng = engines
    jv, jt = jclip.CLIPVisionConfig(**VISION), jclip.CLIPTextConfig(**TEXT)
    vparams = _random_params(jax.eval_shape(lambda: jclip.CLIPVisionEncoder(
        jv).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))), 21)
    tparams = _random_params(jax.eval_shape(lambda: jclip.CLIPTextTower(
        jt).init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))), 22)
    ji = JaxI2AEngine(jeng, jv, jt, vision_params=vparams,
                      text_params=tparams)
    pi = I2AEngine(eng, pclip.CLIPVisionConfig(**VISION),
                   pclip.CLIPTextConfig(**TEXT), vision_params=vparams,
                   text_params=tparams, device="cpu")
    image = np.random.RandomState(23).randint(0, 255, (32, 32, 3)).astype(
        np.uint8)
    return ji, pi, image


def test_contexts_match_jax(i2a):
    ji, pi, image = i2a
    ctx, ref = pi.embed_image(image), np.asarray(ji.embed_image(image))
    assert ctx.shape == ref.shape == (1, 1, 32)
    np.testing.assert_allclose(ctx.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(torch.linalg.norm(ctx, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(pi.uncond.numpy(), np.asarray(ji._uncond),
                               atol=1e-5, rtol=0)


def test_ddim_core_matches_jax(i2a):
    """The JAX engine's ``_sample_fn`` (DDIM, scale 3) and the port's
    ``sample`` on the same image context and initial noise."""
    ji, pi, image = i2a
    t2a = ji.t2a
    h, w = t2a.cfg.latent_hw
    x_T = np.random.RandomState(24).randn(1, h, w, 4).astype(np.float32)
    ctx = ji.embed_image(image)
    ref = t2a._sample_fn(t2a.params, ctx, ji._uncond, jax.random.PRNGKey(0),
                         jnp.asarray(x_T), 3.0, STEPS, h, w)
    mel = pi.sample(torch.from_numpy(np.array(ctx)),
                    torch.from_numpy(x_T.transpose(0, 3, 1, 2).copy()),
                    3.0, STEPS)
    # the T2A core's bound: STEPS x 2 UNet evals and the VAE decoder on
    # shared weights, 2e-4 absolute on outputs in [0, 1]
    np.testing.assert_allclose(mel.numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2),
                               atol=2e-4, rtol=0)
    assert float(mel.std()) > 0.0


def test_img2audio_returns_wav_and_rate(i2a):
    _, pi, image = i2a
    cfg = pi.t2a.cfg
    wav, sr = pi.img2audio(image, ddim_steps=STEPS)
    again, _ = pi.img2audio(image, ddim_steps=STEPS)
    assert sr == 16000
    assert wav.shape == (cfg.mel_len * pi.t2a.vocoder.hop_size,)
    assert np.isfinite(wav).all() and wav.std() > 0.0
    np.testing.assert_array_equal(wav, again)     # seeded: seed=55 each call
    other, _ = pi.img2audio(image, seed=56, ddim_steps=STEPS)
    assert np.abs(other - wav).max() > 1e-6
