"""The T2I slice's models against the JAX package on shared parameters: a
3-level UNet in the SD layout with attention at ds 1 and 2 only (its ds-4
level has none, as the SD-1.x UNet's ds-8 level), and the RGB image VAE's
decode (``test_torch_t2i.py``'s configs, widened to a second level)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiogpt_tpu.models.diffusion import UNetConfig as JaxUNetConfig
from audiogpt_tpu.models.diffusion import UNetModel as JaxUNet
from audiogpt_tpu.models.diffusion import VAEConfig as JaxVAEConfig
from audiogpt_tpu.models.diffusion.vae import AutoencoderKL as JaxVAE
from audiogpt_tpu_torch.models.diffusion import (AutoencoderKL, UNetConfig,
                                                 UNetModel, VAEConfig)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_t2a import _random_params
from test_torch_t2i import UNET, VAE

torch.set_num_threads(2)

UNET3 = dict(UNET, channel_mult=(1, 2, 2), attention_resolutions=(1, 2))
VAE2 = dict(VAE, ch_mult=(1, 2), resolution=16)


def test_unet_three_levels_matches_jax():
    """Attention at ds 1 and 2 of 3 levels: the constructor must skip the
    ds-4 level's blocks as the JAX loop does (strict loading checks it)."""
    jcfg = JaxUNetConfig(use_checkpoint=False, **UNET3)
    junet = JaxUNet(jcfg)
    params = _random_params(jax.eval_shape(
        junet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 32))), seed=4)
    unet = UNetModel(UNetConfig(**UNET3)).eval()
    load_jax_params(unet, params)
    names = {n.split(".")[0] for n, _ in unet.named_parameters()}
    assert {"down_1_0_attn", "up_1_1_attn", "mid_attn"} <= names
    assert not any(n.startswith(("down_2_", "up_2_")) and n.endswith("attn")
                   for n in names)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([3, 700], np.int32)
    ctx = rng.randn(2, 16, 32).astype(np.float32)
    ref = jax.jit(junet.apply)(params, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(ctx))
    with torch.inference_mode():
        got = unet(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                   torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2),
                               atol=1e-4, rtol=0)


def test_image_vae_decode_matches_jax():
    """The RGB VAE (``attn_resolutions=()``: the mid block's single-head
    attention only) decodes a latent as the JAX one does."""
    jvae = JaxVAE(JaxVAEConfig(**VAE2))
    params = _random_params(jax.eval_shape(
        jvae.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))), seed=5)
    vae = AutoencoderKL(VAEConfig(**VAE2)).eval()
    load_jax_params(vae, params)
    z = np.random.RandomState(5).randn(1, 8, 8, 4).astype(np.float32)
    ref = jax.jit(lambda p, z: jvae.apply(p, z, method=JaxVAE.decode))(
        params, jnp.asarray(z))
    with torch.inference_mode():
        got = vae.decode(torch.from_numpy(z.transpose(0, 3, 1, 2).copy()))
    assert got.shape == (1, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2),
                               atol=1e-4, rtol=0)
