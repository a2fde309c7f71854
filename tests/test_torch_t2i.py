"""The T2I slice (``audiogpt_tpu_torch/engines/t2i.py``) against the JAX
engine on shared parameters: the CLIP tokenizer and the engine's EOT-padded
framing, the CLIP text tower's token states and the ``unet_bf16`` core;
then the tool's call. The f32 sampler cores are in
``test_torch_t2i_samplers.py``, the SD-layout UNet and the RGB VAE in
``test_torch_t2i_models.py`` (each JAX program compiles for seconds)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.t2i import T2IConfig as JaxT2IConfig
from audiogpt_tpu.engines.t2i import T2IEngine as JaxT2IEngine
from audiogpt_tpu.models.diffusion import UNetConfig as JaxUNetConfig
from audiogpt_tpu.models.diffusion import UNetModel as JaxUNet
from audiogpt_tpu.models.diffusion import VAEConfig as JaxVAEConfig
from audiogpt_tpu.models.diffusion.vae import AutoencoderKL as JaxVAE
from audiogpt_tpu.models.textenc.clip import CLIPTextConfig as JaxTextConfig
from audiogpt_tpu.models.textenc.clip import CLIPTextTower as JaxTextTower
from audiogpt_tpu.text.bpe import ClipTokenizer as JaxClipTokenizer
from audiogpt_tpu_torch.engines import T2IConfig, T2IEngine
from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
from audiogpt_tpu_torch.models.textenc.clip import CLIPTextConfig
from audiogpt_tpu_torch.text.bpe import ClipTokenizer
from test_torch_t2a import _random_params

torch.set_num_threads(2)

#: the engine's: one UNet level (attention at ds 1 and in the middle block)
#: and a VAE without resampling, the least the JAX sampler programs compile
UNET = dict(in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1,),
            num_heads=2, context_dim=32)
VAE = dict(ch=32, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(),
           in_channels=3, out_ch=3, z_channels=4, embed_dim=4, resolution=8)
TEXT = dict(vocab_size=49408, context_length=16, width=32, layers=1,
            heads=2, embed_dim=32)
SIZE = dict(height=8, width=8)
PROMPTS = ["a photo of an astronaut riding a horse on mars",
           "Café Déjà-vu, 3 CATS & 2 dogs!!", ""]


def jax_engine(tokenizer="auto"):
    """A JAX ``T2IEngine`` at the tiny config on seeded numpy params (no
    init compiled) and the port's on the same params."""
    jcfg = JaxT2IConfig(unet=JaxUNetConfig(use_checkpoint=False, **UNET),
                        vae=JaxVAEConfig(**VAE), text=JaxTextConfig(**TEXT),
                        **SIZE)

    def init():
        k = jax.random.PRNGKey(0)
        return {"unet": JaxUNet(jcfg.unet).init(
                    k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                    jnp.zeros((1, 2, 32))),
                "vae": JaxVAE(jcfg.vae).init(k, jnp.zeros((1, 8, 8, 3))),
                "text": JaxTextTower(jcfg.text).init(
                    k, jnp.zeros((1, 4), jnp.int32))}

    params = _random_params(jax.eval_shape(init), seed=3)
    jeng = JaxT2IEngine(jcfg, params=params, tokenizer=tokenizer)
    cfg = T2IConfig(unet=UNetConfig(**UNET), vae=VAEConfig(**VAE),
                    text=CLIPTextConfig(**TEXT), **SIZE)
    return jeng, T2IEngine(cfg, params=params, tokenizer=tokenizer,
                           device="cpu")


def sample_cores(jeng, eng, sampler, steps, seed):
    """The JAX ``_sample_fn`` and the port's ``sample`` on the same
    contexts and initial noise at the tool's scale 7.5 → NHWC images."""
    rng = np.random.RandomState(seed)
    ctx = rng.randn(2, 16, 32).astype(np.float32)
    unc = rng.randn(2, 16, 32).astype(np.float32)
    x_T = rng.randn(2, 8, 8, 4).astype(np.float32)                # NHWC
    ref = jeng._sample_fn(jeng.params, jnp.asarray(ctx), jnp.asarray(unc),
                          jax.random.PRNGKey(0), jnp.asarray(x_T), 7.5,
                          steps, sampler)
    got = eng.sample(torch.from_numpy(ctx), torch.from_numpy(unc),
                     torch.from_numpy(x_T.transpose(0, 3, 1, 2).copy()),
                     7.5, steps, sampler)
    return got.permute(0, 2, 3, 1).numpy(), np.asarray(ref)


@pytest.fixture(scope="module")
def engines():
    return jax_engine()


def test_clip_tokenizer_matches_jax():
    jt, pt = JaxClipTokenizer(), ClipTokenizer()
    for text in PROMPTS:
        assert pt(text) == jt(text)
        assert pt.decode(pt(text)) == jt.decode(jt(text))
    np.testing.assert_array_equal(pt.framed(PROMPTS), jt.framed(PROMPTS))
    assert (pt.sot, pt.eot) == (49406, 49407)


def test_tokenize_pads_with_eot_as_jax(engines):
    jeng, eng = engines
    long = " ".join(["horse"] * 40)
    ids = eng._tokenize(PROMPTS + [long])
    np.testing.assert_array_equal(ids, jeng._tokenize(PROMPTS + [long]))
    assert ids[2, 0] == 49406 and (ids[2, 1:] == 49407).all()


def test_text_tower_sequence_matches_jax(engines):
    jeng, eng = engines
    ids = eng._tokenize(PROMPTS)
    got = eng.encode_ids(ids)
    assert got.shape == (3, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jeng.encode_ids(ids)),
                               atol=1e-5, rtol=0)


def test_unet_bf16_matches_jax(engines):
    """``unet_bf16``: both engines run a bf16 copy of the same f32 UNet.
    Each framework rounds to bf16 at other points (GroupNorm's f32 island,
    the products' accumulation), and the tool's scale 7.5 multiplies the
    difference of the CFG pair's eps: measured 4.7e-2 between the two bf16
    engines on images in [0, 1], 3.6e-2 between either's bf16 and f32
    cores. The bound is 0.1 absolute."""
    jeng, eng = engines
    jb = JaxT2IEngine(dataclasses.replace(jeng.cfg, unet_bf16=True),
                      params=jeng.params, tokenizer=None)
    pb = T2IEngine(dataclasses.replace(eng.cfg, unet_bf16=True),
                   params=jeng.params, tokenizer=None, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in pb._run.parameters())
    assert all(p.dtype == torch.float32 for p in pb.unet.parameters())
    got, ref = sample_cores(jb, pb, "ddim", 3, seed=7)
    np.testing.assert_allclose(got, ref, atol=0.1, rtol=0)


def test_call_writes_png_under_media_root(engines, tmp_path):
    from PIL import Image

    _, eng = engines
    eng.media_root = str(tmp_path)
    rel = eng("a red bicycle")
    assert rel.startswith("image" + os.sep) and rel.endswith(".png")
    with Image.open(tmp_path / rel) as img:
        assert img.size == (8, 8) and img.mode == "RGB"
    a = eng.txt2img("a red bicycle", steps=2, seed=1)
    b = eng.txt2img("a red bicycle", steps=2, seed=1)
    assert a.shape == (1, 8, 8, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_engine_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T2IEngine(T2IConfig(unet=UNetConfig(**UNET), vae=VAEConfig(**VAE),
                            text=CLIPTextConfig(**TEXT), **SIZE),
                  tokenizer=None)
