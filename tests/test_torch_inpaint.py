"""Port ``T2AEngine.inpaint`` against the JAX engine's, on tiny configs with
the JAX parameters carried across: an all-keep mask (whose output is
decode(z0), whatever the noise), and partial 1-D and 2-D masks under DDIM
and DPM-Solver++ with JAX's initial and per-step noise replayed from its
key splits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.t2a import T2AConfig as JaxT2AConfig
from audiogpt_tpu.engines.t2a import T2AEngine as JaxT2AEngine
from audiogpt_tpu.engines.vocoder import VocoderEngine as JaxVocoderEngine
from audiogpt_tpu.models.diffusion import UNetConfig as JaxUNetConfig
from audiogpt_tpu.models.diffusion import VAEConfig as JaxVAEConfig
from audiogpt_tpu.models.textenc import BertConfig as JaxBertConfig
from audiogpt_tpu.models.textenc import CLAPTextConfig as JaxCLAPConfig
from audiogpt_tpu.models.vocoder.bigvgan import BigVGANConfig as JaxVocConfig
from audiogpt_tpu_torch.engines import T2AConfig, T2AEngine, VocoderEngine
from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
from audiogpt_tpu_torch.models.textenc import BertConfig, CLAPTextConfig
from audiogpt_tpu_torch.models.vocoder import BigVGANConfig
from test_torch_t2a import BERT, UNET, VAE, VOC, _random_params

torch.set_num_threads(2)

#: a 32-frame canvas (8192 samples at hop 256), latent 8 × 16
T2A = dict(mel_bins=16, mel_len=32, inpaint_mel_len=32, timesteps=100)
STEPS = 3
#: a chain of f32 models with shared weights (VAE encode, STEPS × UNet,
#: VAE decode, vocoder): 2e-4 absolute on a wav in [-1, 1]
ATOL = 2e-4


@pytest.fixture(scope="module")
def engines():
    jvoc = JaxVocoderEngine("bigvgan", cfg=JaxVocConfig(aa_impl="literal",
                                                        **VOC),
                            params={}, buckets=(T2A["mel_len"],))
    jvoc.params = _random_params(jax.eval_shape(
        jvoc.model.init, jax.random.PRNGKey(1),
        jnp.zeros((1, 16, VOC["num_mels"]))), seed=1)
    jeng = JaxT2AEngine(JaxT2AConfig(
        unet=JaxUNetConfig(use_checkpoint=False, **UNET),
        vae=JaxVAEConfig(**VAE),
        clap=JaxCLAPConfig(bert=JaxBertConfig(**BERT), d_proj=32,
                           max_length=16), **T2A), params={}, vocoder=jvoc)
    jeng.params = _random_params(
        jax.eval_shape(jeng.init_params, jax.random.PRNGKey(0)), seed=2)
    voc = VocoderEngine("bigvgan", cfg=BigVGANConfig(**VOC),
                        params=jvoc.params, buckets=(T2A["mel_len"],),
                        device="cpu")
    eng = T2AEngine(T2AConfig(
        unet=UNetConfig(**UNET), vae=VAEConfig(**VAE),
        clap=CLAPTextConfig(bert=BertConfig(**BERT), d_proj=32,
                            max_length=16), **T2A),
        params=jeng.params, vocoder=voc, device="cpu")
    return jeng, eng


def _wav(seed, n=7000):
    """Shorter than the canvas, so that both sides pad it."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return (0.2 * rng.randn(n) + 0.4 * np.sin(2 * np.pi * 500.0 * t)
            ).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())


def _replay(rng, shape, n_steps, sampler):
    """The initial latent and per-step blend noise the JAX sampler draws from
    ``rng`` (``samplers.py:92-124`` for DDIM, ``:230-264`` for DPM++)."""
    rng, k0 = jax.random.split(rng)
    keys = jax.random.split(rng, n_steps)
    if sampler == "ddim":
        keys = [jax.random.split(k)[0] for k in keys]
    return (_nchw(jax.random.normal(k0, shape)),
            [_nchw(jax.random.normal(k, shape)) for k in keys])


@pytest.mark.parametrize("two_d", [False, True])
def test_inpaint_all_keep_matches_jax(engines, two_d):
    jeng, eng = engines
    frames = T2A["inpaint_mel_len"]
    shape = (frames, T2A["mel_bins"]) if two_d else frames
    mask = np.ones(shape, np.float32)
    wav = _wav(0)
    ref = jeng.inpaint(wav, mask, text="rain", ddim_steps=STEPS)
    got = eng.inpaint(wav, mask, text="rain", ddim_steps=STEPS)
    assert got.shape == ref.shape == (frames * eng.vocoder.hop_size,)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("sampler,two_d,scale", [("ddim", False, 1.0),
                                                 ("dpmpp", True, 2.0)])
def test_inpaint_partial_mask_matches_jax(engines, sampler, two_d, scale):
    """JAX's public ``inpaint`` against the port's inputs → core → vocoder
    with the draws JAX makes from the key its engine splits off."""
    jeng, eng = engines
    frames, bins = T2A["inpaint_mel_len"], T2A["mel_bins"]
    if two_d:
        mask = np.ones((frames - 5, bins), np.float32)  # padded with keep
        mask[6:20, 3:12] = 0.0
    else:
        mask = np.ones(frames - 3, np.float32)          # padded with 0
        mask[9:21] = 0.0
    wav = _wav(1, n=9000)
    rng = jax.random.split(jeng._rng)[1]               # what inpaint takes
    ref = jeng.inpaint(wav, mask, text="a bell", ddim_steps=STEPS,
                       scale=scale, sampler=sampler)

    mel01, mask_latent = eng.inpaint_inputs(wav, mask)
    assert mask_latent.shape == (1, 4, bins // 2, frames // 2)
    assert 0.0 < float(mask_latent.mean()) < 1.0
    ctx, uc = eng.encode_text(["a bell", ""]).chunk(2)
    if scale == 1.0:
        uc = ctx
    h, w = mask_latent.shape[2:]
    n_steps = len(eng.schedule.ddim_steps(STEPS)[0])
    x_T, noise = _replay(rng, (1, h, w, 4), n_steps, sampler)
    out = eng.inpaint_core(mel01, mask_latent, ctx, uc, x_T, noise, scale,
                           STEPS, sampler)
    got = eng.vocoder.vocode(out[:, 0])[0].numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_inpaint_refuses_what_it_cannot_run(engines):
    _, eng = engines
    mask = np.ones(T2A["inpaint_mel_len"], np.float32)
    with pytest.raises(ValueError, match="sampler"):
        eng.inpaint(_wav(2), mask, ddim_steps=STEPS, sampler="plms")


def test_inpaint_under_unet_bf16_equals_f32(engines):
    """An engine built with ``unet_bf16`` keeps its f32 UNet and inpaints
    with it, as the JAX engine's inpaint core does: the same weights and
    draws give the f32 engine's wav, while its txt2audio samplers run the
    bf16 copy."""
    jeng, eng = engines
    mask = np.ones(T2A["inpaint_mel_len"], np.float32)
    mask[9:21] = 0.0
    wavs = {}
    for bf16 in (False, True):
        e = T2AEngine(dataclasses.replace(eng.cfg, unet_bf16=bf16),
                      params=jeng.params, vocoder=eng.vocoder, device="cpu")
        assert (e._run is e.unet) != bf16
        wavs[bf16] = e.inpaint(_wav(2), mask, text="a bell",
                               ddim_steps=STEPS)
    assert np.isfinite(wavs[True]).all() and wavs[True].std() > 0
    np.testing.assert_array_equal(wavs[True], wavs[False])
