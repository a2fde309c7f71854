"""Port CLAP text tower (WordPiece tokenizer, BERT, projection) against the
JAX package, with the JAX parameters carried across by ``load_jax_params``
and a padding mask on the same token ids."""

import jax
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.textenc import BertConfig as JaxBertConfig
from audiogpt_tpu.models.textenc import CLAPTextConfig as JaxCLAPConfig
from audiogpt_tpu.models.textenc import CLAPTextEncoder as JaxCLAP
from audiogpt_tpu.models.textenc.clap import \
    WordPieceTokenizer as JaxTokenizer
from audiogpt_tpu_torch.models.textenc import (
    BertConfig,
    CLAPTextConfig,
    CLAPTextEncoder,
    WordPieceTokenizer,
)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(2)

#: f32 through two post-LN layers and the projection, shared weights
ATOL = 1e-4

TEXTS = ["a dog barks in the rain", "", "Thunder-storm, with HEAVY rain!!",
         "unbelievably xylophonic zzzqq 1234", "a " * 100]

BERT = dict(vocab_size=2000, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=80)


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


@pytest.mark.parametrize("vocab_size", [30522, 2000])
def test_tokenizer_matches_jax(vocab_size):
    """The bundled vocab at full size; the hash-bucket fallback when the
    vocab does not fit (the same process, so the same string hashes)."""
    port, ref = WordPieceTokenizer(vocab_size=vocab_size), \
        JaxTokenizer(vocab_size=vocab_size)
    assert bool(port.vocab) == (vocab_size == 30522)
    for text in TEXTS:
        for max_len in (16, 77):
            ids, mask = port.encode(text, max_len)
            ref_ids, ref_mask = ref.encode(text, max_len)
            np.testing.assert_array_equal(ids, ref_ids)
            np.testing.assert_array_equal(mask, ref_mask)
            assert ids.dtype == mask.dtype == np.int32


def test_clap_text_encoder_matches_jax():
    jcfg = JaxCLAPConfig(bert=JaxBertConfig(**BERT), d_proj=24, max_length=16)
    cfg = CLAPTextConfig(bert=BertConfig(**BERT), d_proj=24, max_length=16)
    tok = WordPieceTokenizer(vocab_size=2000)
    ids, mask = (np.stack(a) for a in zip(*(tok.encode(t, 16)
                                            for t in TEXTS[:3])))
    jmodel = JaxCLAP(jcfg)
    params = _random_params(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), ids, mask), seed=0)
    ref = np.asarray(jax.jit(jmodel.apply)(params, ids, mask))
    ref_cls = np.asarray(jax.jit(lambda p, i, m: jmodel.apply(
        p, i, m, method=JaxCLAP.cls_embedding))(params, ids, mask))
    model = CLAPTextEncoder(cfg)
    load_jax_params(model, params)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        got = model(ids_t, mask_t)
        got_cls = model.cls_embedding(ids_t, mask_t)
    assert got.shape == (3, 16, 24)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_cls.numpy(), ref_cls, atol=ATOL, rtol=0)
