"""Port HiFi-GAN (with the NSF source), ParallelWaveGAN and MelGAN
(``audiogpt_tpu_torch/models/vocoder/{hifigan,pwg}.py``) and the new
``VocoderEngine`` kinds against the JAX package on shared parameters. The
random draws (NSF's initial phase and normals, PWG's input noise) are JAX's
own, replayed into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.vocoder import VocoderEngine as JaxVocoderEngine
from audiogpt_tpu.models.vocoder import hifigan as jh
from audiogpt_tpu.models.vocoder import pwg as jp
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.vocoder import hifigan as ph
from audiogpt_tpu_torch.models.vocoder import pwg as pp
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_bigvgan import _random_params

torch.set_num_threads(2)

#: f32 through ~20 convs on shared weights, summed in other orders
ATOL = 1e-5

HIFI = dict(upsample_initial_channel=16, upsample_rates=(4, 4),
            upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 2)), harmonic_num=2)
PWG = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
           skip_channels=8, upsample_scales=(2, 3))
MELGAN = dict(channels=16, stacks=2)


def init_params(module, *args, seed=0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return jax.tree.map(np.asarray, _random_params(shapes, seed))


def mel(frames, seed=0, batch=2):
    return np.random.RandomState(seed).randn(batch, frames, 80).astype(
        np.float32)


def f0_track(frames, seed=0, batch=2):
    """Voiced 100–250 Hz with an unvoiced tail."""
    f0 = np.random.RandomState(seed).uniform(100, 250, (batch, frames))
    f0[:, -3:] = 0.0
    return f0.astype(np.float32)


def port(gen_cls, cfg, params):
    model = gen_cls(cfg)
    load_jax_params(model, params)
    return model.eval()


def ncw(x):
    return torch.from_numpy(x).transpose(1, 2)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan_matches_jax(resblock):
    jcfg = jh.HifiGANConfig(resblock=resblock, **HIFI)
    m = mel(10, seed=1)
    params = init_params(jh.HifiGANGenerator(jcfg), jnp.asarray(m))
    ref = np.asarray(jax.jit(jh.HifiGANGenerator(jcfg).apply)(params, m))
    model = port(ph.HifiGANGenerator, ph.HifiGANConfig(resblock=resblock,
                                                       **HIFI), params)
    with torch.no_grad():
        got = model(ncw(m)).numpy()
    assert got.shape == ref.shape == (2, 10 * 16)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan_nsf_matches_jax_with_replayed_draws(resblock):
    """NSF at S = 160 samples: the phase's running sum is short enough for
    f32 to agree (at the app's 262 144 samples the sum order matters)."""
    jcfg = jh.HifiGANConfig(resblock=resblock, use_nsf=True, **HIFI)
    m, f0 = mel(10, seed=2), f0_track(10, seed=3)
    params = init_params(jh.HifiGANGenerator(jcfg), jnp.asarray(m),
                         jnp.asarray(f0), seed=4)
    key = jax.random.PRNGKey(7)
    h = jcfg.harmonic_num + 1

    def run(params, m, f0):
        """The generator, its source's draws and the source alone."""
        k_noise, k_phase = jax.random.split(key)
        return (jh.HifiGANGenerator(jcfg).apply(params, m, f0, rng=key),
                jax.random.uniform(k_phase, (2, 1, h)),
                jax.random.normal(k_noise, (2, 160, h)),
                jh.harmonic_source(f0, 16, 22050, 2, 0.1, 0.003, 0.0, key))

    ref, phase, noise, jsrc = map(np.array, jax.jit(run)(params, m, f0))
    draws = (torch.from_numpy(phase), torch.from_numpy(noise))
    model = port(ph.HifiGANGenerator,
                 ph.HifiGANConfig(resblock=resblock, use_nsf=True, **HIFI),
                 params)
    with torch.no_grad():
        got = model(ncw(m), torch.from_numpy(f0), draws).numpy()
        src = ph.harmonic_source(torch.from_numpy(f0), 16, 22050, 2, 0.1,
                                 0.003, 0.0, draws)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(src.numpy(), jsrc.transpose(0, 2, 1),
                               atol=ATOL, rtol=0)
    # the source is not silent, and the noise convs carry it
    with torch.no_grad():
        plain = model(ncw(m)).numpy()
    assert np.abs(got - plain).max() > 1e-3


@pytest.mark.parametrize("upsample", ["repeat", "conv_in"])
def test_pwg_matches_jax_with_replayed_noise(upsample):
    jcfg = jp.PWGConfig(upsample=upsample, **PWG)
    m = mel(10, seed=5)
    params = init_params(jp.PWGGenerator(jcfg), jnp.asarray(m), seed=6)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 60)))
    # no noise given: the JAX generator draws PRNGKey(0), which is `noise`
    ref = np.asarray(jax.jit(jp.PWGGenerator(jcfg).apply)(params, m))
    model = port(pp.PWGGenerator, pp.PWGConfig(upsample=upsample, **PWG),
                 params)
    with torch.no_grad():
        got = model(ncw(m), torch.from_numpy(noise)).numpy()
        drawn = model(ncw(m), torch.Generator().manual_seed(1)).numpy()
    assert got.shape == ref.shape == (2, 60)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert drawn.shape == got.shape and np.abs(drawn - got).max() > 1e-3


@pytest.mark.parametrize("scales", [(2, 3), (4, 2)])
def test_melgan_matches_jax(scales):
    """Odd and even strides: flax's SAME transposed-conv padding splits
    ``2s + s − 2`` unevenly for odd s."""
    jcfg = jp.MelGANConfig(upsample_scales=scales, **MELGAN)
    m = mel(10, seed=7)
    params = init_params(jp.MelGANGenerator(jcfg), jnp.asarray(m), seed=8)
    ref = np.asarray(jax.jit(jp.MelGANGenerator(jcfg).apply)(params, m))
    model = port(pp.MelGANGenerator,
                 pp.MelGANConfig(upsample_scales=scales, **MELGAN), params)
    with torch.no_grad():
        got = model(ncw(m)).numpy()
    assert got.shape == ref.shape == (2, 10 * int(np.prod(scales)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def engine_params(kind, jcfg, seed):
    """The JAX engine's generator params, from ``jax.eval_shape`` (cheaper
    than the engine's compiled init)."""
    model = {"hifigan": jh.HifiGANGenerator, "melgan": jp.MelGANGenerator,
             "pwg": jp.PWGGenerator}[kind](jcfg)
    return init_params(model, jnp.zeros((1, 16, 80)), seed=seed)


KINDS = {
    "hifigan": (jh.HifiGANConfig(**HIFI), ph.HifiGANConfig(**HIFI)),
    "melgan": (jp.MelGANConfig(upsample_scales=(4, 4), **MELGAN),
               pp.MelGANConfig(upsample_scales=(4, 4), **MELGAN)),
    "pwg": (jp.PWGConfig(**{**PWG, "upsample_scales": (4, 4)}),
            pp.PWGConfig(**{**PWG, "upsample_scales": (4, 4)})),
}


@pytest.mark.parametrize("kind", KINDS)
def test_engine_kinds_match_jax(kind):
    """20 frames at the 32-frame bucket, trimmed, as in the JAX engine;
    PWG draws its noise at the bucket's length from JAX's PRNGKey(0) there,
    replayed here through ``vocode(noise=)``."""
    jcfg, cfg = KINDS[kind]
    params = engine_params(kind, jcfg, seed=13)
    jeng = JaxVocoderEngine(kind, cfg=jcfg, params=params, buckets=(16, 32))
    eng = VocoderEngine(kind, cfg=cfg, params=params, buckets=(16, 32),
                        device="cpu")
    m = mel(20, seed=9)
    ref = jeng(m)
    if kind == "pwg":
        noise = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                           (2, 32 * 16)))
        got = eng.vocode(ncw(m), noise=torch.from_numpy(noise)).numpy()
        assert np.abs(eng(m) - got).max() > 1e-3   # the port's own draws
    else:
        got = eng(m)
    assert got.shape == ref.shape == (2, 20 * 16)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert eng(m[0]).shape == (20 * 16,)


def test_engine_default_kind_and_nsf_calls():
    """The default kind is HiFi-GAN V1 (22.05 kHz, hop 256); an NSF engine
    takes f0 per call, pads it with the mel and draws fresh noise from its
    generator on each call (JAX splits a key per call), deterministically
    from ``rng_seed``."""
    eng = VocoderEngine(device="cpu")
    assert (eng.kind, eng.hop_size, eng.cfg.sample_rate,
            eng.cfg.upsample_initial_channel) == ("hifigan", 256, 22050, 512)
    cfg = ph.HifiGANConfig(use_nsf=True, **HIFI)
    m, f0 = mel(20, seed=10, batch=1)[0], f0_track(20, seed=11, batch=1)[0]
    a = VocoderEngine("hifigan", cfg=cfg, buckets=(32,), device="cpu")
    b = VocoderEngine("hifigan", cfg=cfg, buckets=(32,), device="cpu")
    first, second = a(m, f0), a(m, f0)
    assert first.shape == (20 * 16,)
    np.testing.assert_array_equal(first, b(m, f0))
    assert 0 < np.abs(first - second).max()
    assert a(m).shape == (20 * 16,)               # f0 defaults to zeros


@pytest.mark.parametrize("kind", ["hifigan", "melgan", "pwg"])
def test_bf16_engine_matches_jax_bf16(kind):
    """bf16 in both engines on the same f32 parameters: each rounds at
    other points, so they may differ by as much as bf16 differs from f32
    (the JAX engine's own gap), plus one bf16 step of the output (2^-7 for
    |wav| < 1), where the two roundings of the last layer straddle. PWG
    takes the JAX engine's f32 noise (``PRNGKey(0)`` at the bucket's
    length, drawn in f32 inside its bf16 program), replayed as f32."""
    jcfg, cfg = KINDS[kind]
    params = engine_params(kind, jcfg, seed=14)
    jeng = JaxVocoderEngine(kind, cfg=jcfg, params=params, buckets=(32,))
    jbf = JaxVocoderEngine(kind, cfg=jcfg, params=params, buckets=(32,),
                           bf16=True)
    eng = VocoderEngine(kind, cfg=cfg, params=params, buckets=(32,),
                        bf16=True, device="cpu")
    assert all(p.dtype == torch.float32 for p in eng.model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in eng._run.parameters())
    m = mel(20, seed=12)
    ref_f32, ref = jeng(m), jbf(m)
    if kind == "pwg":
        noise = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                           (2, 32 * 16)))
        got = eng.vocode(ncw(m), noise=torch.from_numpy(noise)).numpy()
    else:
        got = eng(m)
    gap = np.abs(ref_f32 - ref).max()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert 0.0 < np.abs(got - ref).max() <= gap + 2.0 ** -7


def test_bf16_nsf_source_is_f32_at_the_apps_length():
    """At the app's 1024 frames × hop 256 = 262 144 samples the phase's
    running sum reaches ≈ 2.7e4 cycles, where a bf16 step is 128 cycles.
    The bf16 engine computes the NSF source in f32, exactly as the f32
    engine does on the same draws, and rounds only the result to bf16 for
    the noise convs (the JAX bf16 engine runs the sum in bf16: ROADMAP
    §C). The f32 source is 2.0e-4 from a float64 one here; a source summed
    in bf16 is 7.3e-2 from it."""
    cfg = ph.HifiGANConfig(use_nsf=True, upsample_initial_channel=16,
                           resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1,),))
    frames, h = 1024, cfg.harmonic_num + 1
    samples = frames * cfg.hop_size
    rs = np.random.RandomState(15)
    m = ncw(mel(frames, seed=15, batch=1))
    f0 = torch.from_numpy(rs.uniform(100, 300, (1, frames)).astype(
        np.float32))
    init_phase = rs.uniform(size=(1, 1, h)).astype(np.float32)
    normals = rs.randn(1, samples, h).astype(np.float32)
    draws = (torch.from_numpy(init_phase), torch.from_numpy(normals))
    sources = {}

    class Captured(Exception):
        pass

    for bf16 in (False, True):
        eng = VocoderEngine("hifigan", cfg=cfg, buckets=(frames,),
                            bf16=bf16, device="cpu")

        def capture(mod, args, bf16=bf16):
            # the source as the first noise conv gets it; the rest of the
            # generator (2.7 s in bf16 on the CPU) is not needed
            sources[bf16] = args[0]
            raise Captured

        eng._run.noise_conv_0.register_forward_pre_hook(capture)
        with pytest.raises(Captured):
            eng.vocode(m, f0, noise=draws)
    assert sources[True].dtype == torch.bfloat16
    assert sources[False].shape == (1, 1, samples)
    torch.testing.assert_close(sources[True],
                               sources[False].to(torch.bfloat16),
                               atol=0, rtol=0)
    f0_up = np.repeat(f0.numpy().astype(np.float64), cfg.hop_size, 1)
    inst = f0_up[..., None] * np.arange(1, h + 1) / cfg.sample_rate
    phase = 2 * np.pi * (np.cumsum(inst, 1) % 1.0 + init_phase)
    ref = np.tanh((cfg.sine_amp * np.sin(phase)
                   + cfg.noise_std * normals).mean(-1))
    np.testing.assert_allclose(sources[False][:, 0].numpy(), ref, atol=1e-3,
                               rtol=0)


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("hifigan", "pwg", "melgan"):
        with pytest.raises(RuntimeError, match="CUDA"):
            VocoderEngine(kind)
    with pytest.raises(ValueError):
        VocoderEngine("wavenet", device="cpu")
