"""The ported slice as a whole: a tiny JAX ``T2AEngine`` and its port, with
the JAX parameters carried across, run the sampler → VAE decode → BigVGAN
core on the same context and initial noise, and the ranked core with a CLAP
scorer; then the port's ``txt2audio_best`` runs end to end, unranked and
ranked."""

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
from test_torch_clap_scorer import make_scorers

torch.set_num_threads(2)

UNET = dict(in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, channel_mult=(1, 2), num_heads=4,
            context_dim=32)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
           z_channels=4, embed_dim=4, resolution=64)
BERT = dict(vocab_size=2000, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=80)
VOC = dict(num_mels=16, upsample_initial_channel=16, upsample_rates=(4, 4),
           upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 2),))
T2A = dict(mel_bins=16, mel_len=32, timesteps=100)


def _random_params(shapes, seed):
    """numpy params for a flax param tree of ``jax.eval_shape`` leaves
    (cheaper than compiling the init): kernels normal · fan_in^-½, norm
    scales 1 + 0.1·N, every other vector (biases, log α/β) 0.1·N, so no
    zero-initialised layer makes an output trivial."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        a = rng.randn(*s.shape)
        if len(s.shape) >= 2:
            a = a / np.sqrt(np.prod(s.shape[:-1]))
        elif path[-1].key == "scale":
            a = 1.0 + 0.1 * a
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def engines():
    # the JAX engines get numpy params of the shapes their init would give
    jcfg = JaxVocConfig(aa_impl="literal", **VOC)
    jvoc = JaxVocoderEngine("bigvgan", cfg=jcfg, params={},
                            buckets=(T2A["mel_len"],))
    jvoc.params = _random_params(jax.eval_shape(
        jvoc.model.init, jax.random.PRNGKey(1),
        jnp.zeros((1, 16, VOC["num_mels"]))), seed=1)
    jeng = JaxT2AEngine(JaxT2AConfig(
        unet=JaxUNetConfig(use_checkpoint=False, **UNET),
        vae=JaxVAEConfig(**VAE),
        clap=JaxCLAPConfig(bert=JaxBertConfig(**BERT), d_proj=32,
                           max_length=16), **T2A), params={}, vocoder=jvoc)
    jeng.params = _random_params(
        jax.eval_shape(jeng.init_params, jax.random.PRNGKey(0)), seed=0)
    voc = VocoderEngine("bigvgan", cfg=BigVGANConfig(**VOC),
                        params=jvoc.params, buckets=(T2A["mel_len"],),
                        device="cpu")
    eng = T2AEngine(T2AConfig(
        unet=UNetConfig(**UNET), vae=VAEConfig(**VAE),
        clap=CLAPTextConfig(bert=BertConfig(**BERT), d_proj=32,
                            max_length=16), **T2A),
        params=jeng.params, vocoder=voc, device="cpu")
    return jeng, eng


def test_encode_text_matches_jax(engines):
    jeng, eng = engines
    texts = ["a dog barks in the rain", ""]
    np.testing.assert_allclose(eng.encode_text(texts).numpy(),
                               np.asarray(jeng.encode_text(texts)),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("sampler,steps", [("dpmpp", 4), ("ddim", 5)])
def test_sample_vocode_core_matches_jax(engines, sampler, steps):
    jeng, eng = engines
    rng = np.random.RandomState(7)
    n, (h, w) = 2, eng.cfg.latent_hw
    ctx = rng.randn(n, 16, 32).astype(np.float32)
    unc = rng.randn(n, 16, 32).astype(np.float32)
    x_T = rng.randn(n, h, w, 4).astype(np.float32)               # NHWC
    mel_ref, wav_ref = jeng._sample_vocode_fn(
        jeng.params, jeng.vocoder.params, jnp.asarray(ctx), jnp.asarray(unc),
        jax.random.PRNGKey(0), jnp.asarray(x_T), 1.5, steps, h, w, sampler)
    mel = eng.sample_core(torch.from_numpy(ctx), torch.from_numpy(unc),
                          torch.from_numpy(x_T.transpose(0, 3, 1, 2).copy()),
                          1.5, steps, sampler)
    wav = eng.vocoder.vocode(mel[:, 0])
    # a chain of stacked f32 models (steps x 2N UNet evals, the VAE decoder,
    # the vocoder) with shared weights: 2e-4 absolute on O(1) outputs
    np.testing.assert_allclose(mel.numpy(),
                               np.asarray(mel_ref).transpose(0, 3, 1, 2),
                               atol=2e-4, rtol=0)
    assert wav.shape == (n, w * 2 * eng.vocoder.hop_size)
    np.testing.assert_allclose(wav.numpy(), np.asarray(wav_ref), atol=2e-4,
                               rtol=0)


def test_unet_bf16_matches_jax(engines):
    """``unet_bf16``: both engines cast the same f32 UNet parameters to bf16
    and run the sampler → VAE core on the same inputs."""
    jeng, eng = engines
    jb = JaxT2AEngine(dataclasses.replace(jeng.cfg, unet_bf16=True),
                      params=jeng.params)
    pb = T2AEngine(dataclasses.replace(eng.cfg, unet_bf16=True),
                   params=jeng.params, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in pb._run.parameters())
    assert all(p.dtype == torch.float32 for p in pb.unet.parameters())
    rng = np.random.RandomState(8)
    n, (h, w) = 2, eng.cfg.latent_hw
    ctx = rng.randn(n, 16, 32).astype(np.float32)
    unc = rng.randn(n, 16, 32).astype(np.float32)
    x_T = rng.randn(n, h, w, 4).astype(np.float32)               # NHWC
    mel_ref = jb._sample_fn(jb.params, jnp.asarray(ctx), jnp.asarray(unc),
                            jax.random.PRNGKey(0), jnp.asarray(x_T), 1.5, 3,
                            h, w, "dpmpp")
    mel = pb.sample_core(torch.from_numpy(ctx), torch.from_numpy(unc),
                         torch.from_numpy(x_T.transpose(0, 3, 1, 2).copy()),
                         1.5, 3, "dpmpp")
    assert mel.dtype == torch.float32
    # each UNet layer rounds to bf16 (2^-9 relative) in both frameworks, at
    # other points (XLA fuses elementwise chains and drops roundings inside
    # them, PyTorch rounds after every op), so the two bf16 runs differ by
    # about what bf16 differs from f32 (1.6e-2 and 1.2e-2 at this seed);
    # 3e-2 absolute on outputs in [0, 1]
    np.testing.assert_allclose(mel.numpy(),
                               np.asarray(mel_ref).transpose(0, 3, 1, 2),
                               atol=3e-2, rtol=0)


def test_txt2audio_best_end_to_end(engines):
    _, eng = engines
    mel, wav, scores = eng.txt2audio_best("a dog barks in the rain",
                                          n_samples=3, seed=0)
    cfg = eng.cfg
    assert mel.shape == (cfg.mel_len, cfg.mel_bins) and mel.dtype == np.float32
    assert wav.shape == (cfg.mel_len * eng.vocoder.hop_size,)
    assert wav.dtype == np.float32 and np.isfinite(wav).all()
    assert np.isfinite(mel).all() and mel.min() >= 0.0 and mel.max() <= 1.0
    np.testing.assert_array_equal(scores, np.zeros(3, np.float32))
    again = eng.txt2audio_best("a dog barks in the rain", n_samples=3, seed=0)
    np.testing.assert_array_equal(again[1], wav)   # the seed fixes the noise


#: the ranked fixture's clips are 16384 samples (64 frames at hop 256), long
#: enough for the scorer's 32 kHz Cnn14 frontend to keep one frame after its
#: five pools
RANK_VOC = dict(VOC, upsample_rates=(8, 8, 4),
                upsample_kernel_sizes=(16, 16, 8))
RANK_T2A = dict(T2A, mel_len=64)


@pytest.fixture(scope="module")
def ranked_engines():
    jvoc = JaxVocoderEngine("bigvgan", cfg=JaxVocConfig(aa_impl="literal",
                                                        **RANK_VOC),
                            params={}, buckets=(RANK_T2A["mel_len"],))
    jvoc.params = _random_params(jax.eval_shape(
        jvoc.model.init, jax.random.PRNGKey(1),
        jnp.zeros((1, 16, VOC["num_mels"]))), seed=3)
    jsc, sc = make_scorers(seed=4)
    jeng = JaxT2AEngine(JaxT2AConfig(
        unet=JaxUNetConfig(use_checkpoint=False, **UNET),
        vae=JaxVAEConfig(**VAE),
        clap=JaxCLAPConfig(bert=JaxBertConfig(**BERT), d_proj=32,
                           max_length=16), **RANK_T2A), params={},
        vocoder=jvoc, scorer=jsc)
    jeng.params = _random_params(
        jax.eval_shape(jeng.init_params, jax.random.PRNGKey(0)), seed=5)
    voc = VocoderEngine("bigvgan", cfg=BigVGANConfig(**RANK_VOC),
                        params=jvoc.params, buckets=(RANK_T2A["mel_len"],),
                        device="cpu")
    eng = T2AEngine(T2AConfig(
        unet=UNetConfig(**UNET), vae=VAEConfig(**VAE),
        clap=CLAPTextConfig(bert=BertConfig(**BERT), d_proj=32,
                            max_length=16), **RANK_T2A),
        params=jeng.params, vocoder=voc, scorer=sc, device="cpu")
    return jeng, eng


def test_ranked_core_matches_jax(ranked_engines):
    """The port's ``sample_vocode_rank`` against ``_sample_vocode_rank_fn``
    on the same context and initial noise: scores, winner, its mel and
    wav."""
    jeng, eng = ranked_engines
    text = "a dog barks in the rain"
    rng = np.random.RandomState(9)
    n, (h, w) = 3, eng.cfg.latent_hw
    ctx = rng.randn(n, 16, 32).astype(np.float32)
    unc = rng.randn(n, 16, 32).astype(np.float32)
    x_T = rng.randn(n, h, w, 4).astype(np.float32)               # NHWC
    sc = jeng.scorer
    ids, mask = sc.tokenizer.encode(text, sc.cfg.max_length)
    mel_ref, wav_ref, scores_ref = jeng._sample_vocode_rank_fn(
        jeng.params, jeng.vocoder.params, sc.text_params, sc.audio_params,
        jnp.asarray(ids)[None], jnp.asarray(mask)[None], jnp.asarray(ctx),
        jnp.asarray(unc), jax.random.PRNGKey(0), jnp.asarray(x_T), 1.5, 3, h,
        w, "dpmpp")
    mel, wav, scores = eng.sample_vocode_rank(
        text, torch.from_numpy(ctx), torch.from_numpy(unc),
        torch.from_numpy(x_T.transpose(0, 3, 1, 2).copy()), 1.5, 3, "dpmpp")
    scores_ref = np.asarray(scores_ref)
    # cosine similarities at the end of the whole f32 chain: 1e-5 absolute,
    # well below the gap between the candidates' scores
    np.testing.assert_allclose(scores.numpy(), scores_ref, atol=1e-5, rtol=0)
    assert np.ptp(scores_ref) > 1e-4
    assert int(scores.argmax()) == int(scores_ref.argmax())
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_ref)[..., 0],
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(wav.numpy(), np.asarray(wav_ref), atol=2e-4,
                               rtol=0)


def test_ranked_txt2audio_best_returns_the_argmax(ranked_engines):
    _, eng = ranked_engines
    text = "a dog barks in the rain"
    mel, wav, scores = eng.txt2audio_best(text, n_samples=3, seed=1)
    mels, wavs = eng.txt2audio(text, n_samples=3, seed=1,
                               ddim_steps=eng.cfg.tool_steps,
                               sampler=eng.cfg.tool_sampler)
    assert scores.shape == (3,) and np.isfinite(scores).all()
    np.testing.assert_allclose(scores, eng.scorer.score(text, wavs),
                               atol=1e-6, rtol=0)
    best = int(scores.argmax())
    assert eng.select_best(text, wavs) == best
    np.testing.assert_array_equal(wav, wavs[best])
    np.testing.assert_array_equal(mel, mels[best])
