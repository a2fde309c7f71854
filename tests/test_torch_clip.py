"""Port CLIP towers (``audiogpt_tpu_torch/models/textenc/clip.py``) against
the JAX towers on shared parameters (the tiny configs of
``tests/test_i2a.py``): the normalised embeddings, EOT pooling, causality,
the text tower's sequence output, and ``preprocess_image`` of an array."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.textenc import clip as jclip
from audiogpt_tpu_torch.models.textenc import clip as pclip
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_t2a import _random_params

torch.set_num_threads(2)

#: f32 through one or two pre-LN blocks on shared weights: the normalised
#: embeddings agree to rounding
ATOL = 1e-5
VISION = dict(image_size=32, patch_size=8, width=16, layers=1, heads=2,
              embed_dim=32)
TEXT = dict(vocab_size=100, context_length=16, width=16, layers=1, heads=2,
            embed_dim=32)
TOKS = np.array([[1, 5, 7, 99, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                 [1, 42, 3, 8, 17, 64, 98, 0, 0, 0, 0, 0, 0, 0, 0, 0]],
                np.int32)


def _towers(jmodel, pmodel, example, seed):
    params = _random_params(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), example)), seed)
    load_jax_params(pmodel, params)
    return params, pmodel.eval()


@pytest.fixture(scope="module")
def vision():
    jm = jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(**VISION))
    params, pm = _towers(jm, pclip.CLIPVisionEncoder(
        pclip.CLIPVisionConfig(**VISION)), jnp.zeros((1, 32, 32, 3)), 1)
    return jm, params, pm


@pytest.fixture(scope="module")
def text():
    jm = jclip.CLIPTextTower(jclip.CLIPTextConfig(**TEXT))
    params, pm = _towers(jm, pclip.CLIPTextTower(
        pclip.CLIPTextConfig(**TEXT)), jnp.zeros((1, 16), jnp.int32), 2)
    return jm, params, pm


def test_vision_tower_matches_jax(vision):
    jm, params, pm = vision
    img = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(img)))
    with torch.no_grad():
        got = pm(torch.from_numpy(img)).numpy()
    assert got.shape == ref.shape == (2, 32)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("sequence", [False, True])
def test_text_tower_matches_jax(text, sequence):
    jm, params, pm = text
    ref = np.asarray(jm.apply(params, jnp.asarray(TOKS),
                              return_sequence=sequence))
    with torch.no_grad():
        got = pm(torch.from_numpy(TOKS).long(),
                 return_sequence=sequence).numpy()
    assert got.shape == ref.shape == ((2, 16, 16) if sequence else (2, 32))
    if not sequence:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_text_eot_pooling_and_causality(text):
    """Tokens after the EOT (max-id) position cannot change the embedding;
    a token before it does."""
    _, _, pm = text
    toks = torch.from_numpy(TOKS[:1]).long()
    with torch.no_grad():
        z = pm(toks)
        after, before = toks.clone(), toks.clone()
        after[0, 5] = 3
        before[0, 1] = 9
        np.testing.assert_allclose(pm(after).numpy(), z.numpy(), atol=1e-6,
                                   rtol=0)
        assert (pm(before) - z).abs().max() > 1e-6


def test_preprocess_image_of_an_array_matches_jax():
    """A uint8 array already at the tower's size takes no PIL; one of
    another size is centre-cropped and resized as in JAX."""
    rs = np.random.RandomState(4)
    square = rs.randint(0, 255, (32, 32, 3)).astype(np.uint8)
    got = pclip.preprocess_image(square, 32)
    assert got.shape == (1, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jclip.preprocess_image(square, 32))
    wide = rs.randint(0, 255, (40, 56, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pclip.preprocess_image(wide, 32),
                                  jclip.preprocess_image(wide, 32))
