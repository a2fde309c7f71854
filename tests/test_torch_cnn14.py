"""Port Cnn14 (PANN) backbone against the JAX package, with the JAX
``params`` and non-trivial ``batch_stats`` carried across by
``load_jax_params``, on the same waveforms with two lengths in one batch."""

import jax
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.caption.cnn14 import Cnn14Config as JaxConfig
from audiogpt_tpu.models.caption.cnn14 import Cnn14Encoder as JaxCnn14
from audiogpt_tpu_torch.models.caption import Cnn14Config, Cnn14Encoder
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(2)

CHANNELS = (4, 4, 8, 8, 16, 16)


def random_variables(shapes, seed):
    """numpy variables for a flax tree of ``jax.eval_shape`` leaves: kernels
    normal · fan_in^-½, norm scales 1 + 0.1·N, other params 0.1·N; BatchNorm
    statistics mean 0.1·N and var 1 + 0.1·|N|, so that no normalisation is
    the identity."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        a = rng.randn(*s.shape)
        key = path[-1].key
        if key == "var":
            a = 1.0 + 0.1 * np.abs(a)
        elif len(s.shape) >= 2:
            a = a / np.sqrt(np.prod(s.shape[:-1]))
        elif key == "scale":
            a = 1.0 + 0.1 * a
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _wav(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 32000.0
    return (0.3 * rng.randn(batch, n)
            + 0.5 * np.sin(2 * np.pi * 660.0 * t)).astype(np.float32)


@pytest.mark.parametrize("with_head", [False, True])
def test_cnn14_matches_jax_with_two_lengths(with_head):
    wav = _wav(2, 40000, seed=0)
    # 126 frames → 3 after five pools; the second clip's 25000 samples keep 2
    wav_len = np.asarray([40000, 25000], np.int32)
    jmodel = JaxCnn14(JaxConfig(channels=CHANNELS), with_head=with_head)
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), wav, wav_len), seed=1)
    assert set(variables) == {"params", "batch_stats"}
    ref = jax.jit(jmodel.apply)(variables, wav, wav_len)
    model = Cnn14Encoder(Cnn14Config(channels=CHANNELS), with_head=with_head)
    load_jax_params(model, variables)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(wav), torch.from_numpy(wav_len).long())
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(), [3, 2])
    assert got["attn_emb"].shape == (2, 3, 16)
    keys = ["attn_emb", "fc_emb"] + (["clipwise_logits", "clipwise_output"]
                                     if with_head else [])
    assert set(got) == set(keys) | {"attn_emb_len"}
    for key in keys:
        # f32 through 12 convs from a dB frontend (values of O(10)) with
        # shared weights: 1e-5 of each output's largest value
        want = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_cnn14_full_length_without_wav_len():
    wav = _wav(1, 20000, seed=2)
    jmodel = JaxCnn14(JaxConfig(channels=CHANNELS))
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), wav), seed=3)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, wav)["fc_emb"])
    model = Cnn14Encoder(Cnn14Config(channels=CHANNELS))
    load_jax_params(model, variables)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(wav))["fc_emb"].numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_cnn14_needs_six_stages_and_loading_is_strict():
    with pytest.raises(ValueError, match="6 stages"):
        Cnn14Encoder(Cnn14Config(channels=(4, 4, 8)))
    wav = np.zeros((1, 16000), np.float32)
    variables = random_variables(jax.eval_shape(
        JaxCnn14(JaxConfig(channels=CHANNELS)).init, jax.random.PRNGKey(0),
        wav), seed=0)
    model = Cnn14Encoder(Cnn14Config(channels=CHANNELS))
    with pytest.raises(RuntimeError):        # the statistics are missing
        load_jax_params(model, {"params": variables["params"]})
    load_jax_params(model, variables)
    np.testing.assert_array_equal(
        model.conv_block3.bn2.running_var.numpy(),
        variables["batch_stats"]["conv_block3"]["bn2"]["var"])
