"""Port diffusion stack (UNet, AutoencoderKL, schedules, samplers, DDPM)
against the JAX package, with the JAX parameters carried across by
``load_jax_params``, on the same numpy inputs (NHWC there, NCHW here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.diffusion import AutoencoderKL as JaxVAE
from audiogpt_tpu.models.diffusion import DiffusionSchedule as JaxSchedule
from audiogpt_tpu.models.diffusion import UNetConfig as JaxUNetConfig
from audiogpt_tpu.models.diffusion import UNetModel as JaxUNet
from audiogpt_tpu.models.diffusion import VAEConfig as JaxVAEConfig
from audiogpt_tpu.models.diffusion import samplers as jax_samplers
from audiogpt_tpu_torch.models.diffusion import (
    AutoencoderKL,
    DiffusionSchedule,
    UNetConfig,
    UNetModel,
    VAEConfig,
    samplers,
)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(2)

#: f32 through a stacked model (tens of convs, norms and attentions) with
#: shared weights, summed in another order by each framework
ATOL = 1e-4

UNET = dict(in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, channel_mult=(1, 2), num_heads=4,
            context_dim=32)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(32,),
           z_channels=4, embed_dim=4, resolution=64)


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


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_unet_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 12, 4).astype(np.float32)           # NHWC
    t = np.asarray([3, 870], np.int32)
    ctx = rng.randn(2, 7, 32).astype(np.float32)
    jmodel = JaxUNet(JaxUNetConfig(use_checkpoint=False, **UNET))
    params = _random_params(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, t, ctx), seed=1)
    ref = np.asarray(jax.jit(jmodel.apply)(params, x, t, ctx))
    ref = ref.transpose(0, 3, 1, 2)
    model = UNetModel(UNetConfig(**UNET))
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.shape == (2, 4, 8, 12)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_vae_decode_and_encode_match_jax():
    rng = np.random.RandomState(2)
    jvae = JaxVAE(JaxVAEConfig(**VAE))
    params = _random_params(
        jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                       np.zeros((1, 16, 16, 1), np.float32)), seed=3)
    vae = AutoencoderKL(VAEConfig(**VAE))
    load_jax_params(vae, params)
    z = rng.randn(2, 5, 8, 4).astype(np.float32)
    mel = rng.randn(2, 10, 16, 1).astype(np.float32)
    ref_dec = jax.jit(lambda p, z: jvae.apply(p, z, method=JaxVAE.decode))(
        params, z)
    ref_post = jax.jit(lambda p, x: jvae.apply(p, x, method=JaxVAE.encode))(
        params, mel)
    with torch.no_grad():
        dec = vae.decode(_nchw(z))
        post = vae.encode(_nchw(mel))
    assert dec.shape == (2, 1, 10, 16)
    np.testing.assert_allclose(dec.numpy(),
                               np.asarray(ref_dec).transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=0)
    for got, ref in ((post.mean, ref_post.mean), (post.logvar, ref_post.logvar)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref).transpose(0, 3, 1, 2),
                                   atol=ATOL, rtol=0)


def test_schedule_matches_jax():
    j = JaxSchedule.linear(1000, 0.00085, 0.012)
    p = DiffusionSchedule.linear(1000, 0.00085, 0.012)
    np.testing.assert_array_equal(p.betas, j.betas)
    np.testing.assert_array_equal(p.alphas_cumprod, j.alphas_cumprod)
    for n, eta in ((12, 0.0), (100, 0.0), (25, 0.5)):
        for a, b in zip(p.ddim_steps(n, eta), j.ddim_steps(n, eta)):
            np.testing.assert_array_equal(a, b)


def _eps(xp):
    """A toy denoiser written once for both frameworks: elementwise in x,
    per-sample in t and the context, so it is layout-free."""
    def eps(x, t, c):
        tt = t.reshape(-1, 1, 1, 1) * 0.001
        cm = c.mean(axis=(1, 2)) if xp is jnp else c.mean(dim=(1, 2))
        return xp.tanh(0.7 * x + tt + cm.reshape(-1, 1, 1, 1))
    return eps


@pytest.mark.parametrize("name,steps", [("ddim", 10), ("plms", 6),
                                        ("dpmpp", 5)])
@pytest.mark.parametrize("guidance", [1.0, 1.5])
def test_sampler_matches_jax(name, steps, guidance):
    rng = np.random.RandomState(4)
    shape = (2, 4, 5, 6)
    x_T = rng.randn(*shape).astype(np.float32)
    ctx = rng.randn(2, 3, 8).astype(np.float32)
    unc = rng.randn(2, 3, 8).astype(np.float32)
    sched = DiffusionSchedule.linear(100)
    jsched = JaxSchedule.linear(100)
    ref = getattr(jax_samplers, f"{name}_sample")(
        _eps(jnp), jsched, shape, jnp.asarray(ctx), jnp.asarray(unc),
        jax.random.PRNGKey(0), n_steps=steps, guidance_scale=guidance,
        x_T=jnp.asarray(x_T))
    got = getattr(samplers, f"{name}_sample")(
        _eps(torch), sched, torch.from_numpy(x_T), torch.from_numpy(ctx),
        torch.from_numpy(unc), n_steps=steps, guidance_scale=guidance)
    # f32 step arithmetic over ≤ 10 steps of O(1) values
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name", ["ddim", "dpmpp"])
def test_inpaint_blend_matches_jax(name):
    """The mask blend with the toy denoiser: a partial mask, x0, and JAX's
    initial and per-step noise replayed from its key splits."""
    rng = np.random.RandomState(5)
    shape = (1, 4, 5, 6)
    x0 = rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(*shape) > 0.5).astype(np.float32)
    ctx = rng.randn(1, 3, 8).astype(np.float32)
    sched, jsched = DiffusionSchedule.linear(100), JaxSchedule.linear(100)
    steps = 7
    key = jax.random.PRNGKey(3)
    ref = getattr(jax_samplers, f"{name}_sample")(
        _eps(jnp), jsched, shape, jnp.asarray(ctx), None, key,
        n_steps=steps, mask=jnp.asarray(mask), x0=jnp.asarray(x0))
    key, k0 = jax.random.split(key)
    keys = jax.random.split(key, len(sched.ddim_steps(steps)[0]))
    if name == "ddim":
        keys = [jax.random.split(k)[0] for k in keys]
    noise = [torch.from_numpy(np.asarray(jax.random.normal(k, shape)))
             for k in keys]
    x_T = torch.from_numpy(np.asarray(jax.random.normal(k0, shape)))
    got = getattr(samplers, f"{name}_sample")(
        _eps(torch), sched, x_T, torch.from_numpy(ctx), None, n_steps=steps,
        mask=torch.from_numpy(mask), x0=torch.from_numpy(x0), noise=noise)
    # f32 step arithmetic over 8 steps of O(1) values; the kept region is x0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got.numpy()[mask == 1], x0[mask == 1])
    t = 40
    np.testing.assert_allclose(
        sched.q_sample(torch.from_numpy(x0), t, noise[0]).numpy(),
        np.asarray(jsched.q_sample(jnp.asarray(x0), jnp.full((1,), t),
                                   jnp.asarray(noise[0].numpy()))),
        atol=1e-6, rtol=0)


def test_cosine_schedule_matches_jax():
    for n in (6, 1000):
        j, p = JaxSchedule.cosine(n), DiffusionSchedule.cosine(n)
        np.testing.assert_array_equal(p.betas, j.betas)
        np.testing.assert_array_equal(p.alphas_cumprod, j.alphas_cumprod)


def eps_frames(xp):
    """An analytic eps on [B, T, C] frames that depends on x, t and the
    condition (DiffSinger's samplers' layout)."""
    def eps(x, t, c):
        return xp.tanh(0.7 * x + c) * (1.0 + 0.01 * t[:, None, None])
    return eps


def frames_inputs(seed=0):
    """A sample and a condition [2, 10, 4]."""
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 10, 4).astype(np.float32),
            rng.randn(2, 10, 4).astype(np.float32))


def test_ddpm_sample_matches_jax():
    """DiffSinger's ancestral loop: six steps of the cosine schedule from
    x_start with JAX's per-step keys replayed (the linear schedule is
    DiffSinger's, ``test_torch_svs.py``); the last step (t = 0) draws and
    drops its noise. 5e-4: six steps, each rescaling the last one's
    difference."""
    sched = JaxSchedule.cosine(6)
    x, cond = frames_inputs(1)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax.jit(lambda x, c: jax_samplers.ddpm_sample(
        eps_frames(jnp), sched, x.shape, c, key, x_start=x))(x, cond))
    keys = jax.random.split(jax.random.split(key)[0], 6)
    noise = [torch.from_numpy(np.asarray(jax.random.normal(k, x.shape)))
             for k in keys]
    xt, ct = torch.from_numpy(x), torch.from_numpy(cond)
    got = samplers.ddpm_sample(eps_frames(torch), sched, xt, ct, noise)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=0)
    # a generator draws one tensor a step, t = 0 included
    gen, count = torch.Generator().manual_seed(0), \
        torch.Generator().manual_seed(0)
    samplers.ddpm_sample(eps_frames(torch), sched, xt, ct, gen)
    for _ in range(6):
        torch.randn(x.shape, generator=count)
    assert torch.equal(gen.get_state(), count.get_state())
