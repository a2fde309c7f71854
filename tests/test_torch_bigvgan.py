"""Port BigVGAN and ``VocoderEngine`` against the JAX package, with the JAX
parameters carried across by ``load_jax_params``, on the same numpy mels."""

import jax
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.vocoder import VocoderEngine as JaxVocoderEngine
from audiogpt_tpu.models.vocoder.bigvgan import BigVGANConfig as JaxConfig
from audiogpt_tpu.models.vocoder.bigvgan import \
    BigVGANGenerator as JaxGenerator
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.vocoder.bigvgan import (
    BigVGANConfig,
    BigVGANGenerator,
)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(2)

#: f32 through a stack of ~30 convs and activations with shared weights;
#: the two frameworks sum in different orders, and tanh bounds the output
ATOL = 1e-4

TINY = dict(upsample_initial_channel=16, upsample_rates=(4, 4),
            upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 2)))


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


def _jax_params(cfg, seed=0):
    mel = np.zeros((1, 16, cfg.num_mels), np.float32)
    return _random_params(jax.eval_shape(JaxGenerator(cfg).init,
                                         jax.random.PRNGKey(seed), mel), seed)


def _mel(frames, seed=0):
    return np.random.RandomState(seed).randn(2, frames, 80).astype(np.float32)


@pytest.mark.parametrize("resblock,activation", [("1", "snakebeta"),
                                                 ("2", "snake")])
def test_generator_matches_jax(resblock, activation):
    jcfg = JaxConfig(resblock=resblock, activation=activation,
                     aa_impl="literal", **TINY)
    cfg = BigVGANConfig(resblock=resblock, activation=activation, **TINY)
    params = _jax_params(jcfg)
    mel = _mel(13)
    ref = np.asarray(jax.jit(JaxGenerator(jcfg).apply)(params, mel))
    gen = BigVGANGenerator(cfg)
    load_jax_params(gen, params)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel).transpose(1, 2)).numpy()
    assert got.shape == ref.shape == (2, 13 * cfg.hop_size)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_engine_bucket_pad_and_trim_matches_jax():
    """20 frames run at the 32-frame bucket and come back trimmed, as in
    the JAX engine; a 2-D mel gives a 1-D wav."""
    jcfg = JaxConfig(aa_impl="literal", **TINY)
    params = _jax_params(jcfg, seed=1)
    jeng = JaxVocoderEngine("bigvgan", cfg=jcfg, params=params,
                            buckets=(16, 32))
    eng = VocoderEngine("bigvgan", cfg=BigVGANConfig(**TINY), params=params,
                        buckets=(16, 32), device="cpu")
    mel = _mel(20, seed=2)
    got, ref = eng(mel), jeng(mel)
    assert got.shape == ref.shape == (2, 20 * eng.hop_size)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert eng(mel[0]).shape == (20 * eng.hop_size,)
    with pytest.raises(ValueError):
        eng(_mel(40))


def test_strict_loading_rejects_a_mismatched_tree():
    params = _jax_params(JaxConfig(aa_impl="literal", **TINY))
    gen = BigVGANGenerator(BigVGANConfig(**{**TINY,
                                           "resblock_kernel_sizes": (3,),
                                           "resblock_dilation_sizes": ((1,),)}))
    with pytest.raises(RuntimeError):
        load_jax_params(gen, params)


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        VocoderEngine("bigvgan", cfg=BigVGANConfig(**TINY))


def test_bf16_engine_matches_jax_bf16():
    """``bf16=True`` in both engines on the same f32 parameters: generator
    and snake log-α/β cast to bf16 once, mel in as bf16, wav out as f32."""
    jcfg = JaxConfig(aa_impl="literal", **TINY)
    params = _jax_params(jcfg, seed=4)
    mel = _mel(20, seed=5)
    ref_f32 = JaxVocoderEngine("bigvgan", cfg=jcfg, params=params,
                               buckets=(32,))(mel)
    ref = JaxVocoderEngine("bigvgan", cfg=jcfg, params=params, buckets=(32,),
                           bf16=True)(mel)
    eng = VocoderEngine("bigvgan", cfg=BigVGANConfig(**TINY), params=params,
                        buckets=(32,), bf16=True, device="cpu")
    assert all(p.dtype == torch.float32 for p in eng.model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in eng._run.parameters())
    got = eng(mel)
    assert got.dtype == np.float32 and got.shape == ref.shape
    # the two bf16 runs round at other points (the JAX literal chain runs
    # its FIRs in bf16, the port's snake computes in f32 and rounds once),
    # so they may differ by as much as bf16 differs from f32, not more: the
    # tolerance is the JAX engine's own f32-vs-bf16 gap (7.1e-2 here)
    gap = np.abs(ref_f32 - ref).max()
    assert 0.0 < np.abs(got - ref).max() <= gap
    # loading f32 weights refreshes the bf16 copy
    other = _jax_params(jcfg, seed=6)
    gen = BigVGANGenerator(BigVGANConfig(**TINY))
    load_jax_params(gen, other)
    eng.load_state_dict(gen.state_dict())
    want = VocoderEngine("bigvgan", cfg=BigVGANConfig(**TINY), params=other,
                         buckets=(32,), bf16=True, device="cpu")(mel)
    np.testing.assert_array_equal(eng(mel), want)
