"""The T5 / FLAN-T5 text tower and its SentencePiece codec
(``models/textenc/t5.py``, ``text/sentencepiece.py``) against the JAX
package's on the CPU.

The codec: ``write_sp_model``'s bytes, ``parse_sp_model`` and ``encode``,
``encode_pieces`` and ``decode`` equal JAX's (exactly) on a unigram
fixture and texts with unknown characters, runs of spaces and non-ASCII
letters. T5: ``relative_position_bucket`` equal bucket for bucket at
L ∈ {1, 77, 300}; a 2-layer ``T5Encoder`` (d 16, gated GELU, and the
``"relu"`` feed-forward) equal to JAX's on shared weights, with and
without a key mask, within 1e-5 of the output's largest value (f32);
``T5Conditioner``'s ids and masks equal JAX's and its output within the
same bound. JAX's weights come from ``jax.eval_shape`` filled with seeded
numpy (the RMS norms' weights 1 + 0.1·N)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.textenc import t5 as jt5
from audiogpt_tpu.text import sentencepiece as jsp
from audiogpt_tpu_torch.models.textenc import t5 as pt5
from audiogpt_tpu_torch.text import sentencepiece as psp
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_t2a import _random_params

torch.set_num_threads(2)

RTOL = 1e-5
N, C, U = psp.NORMAL, psp.CONTROL, psp.UNKNOWN
PIECES = [
    ("<pad>", 0.0, C), ("</s>", 0.0, C), ("<unk>", 0.0, U),
    ("▁", -2.7, N), ("▁the", -1.2, N), ("▁quick", -3.0, N),
    ("▁t", -2.5, N), ("he", -2.0, N), ("t", -4.0, N), ("h", -4.1, N),
    ("e", -3.9, N), ("q", -4.5, N), ("u", -4.2, N), ("i", -4.0, N),
    ("c", -4.3, N), ("k", -4.4, N), ("▁brown", -3.1, N), ("b", -4.6, N),
    ("r", -4.1, N), ("o", -4.0, N), ("w", -4.5, N), ("n", -3.8, N),
    ("▁fo", -3.3, N), ("x", -4.8, N), ("f", -4.4, N), ("▁ox", -3.6, N),
    ("s", -3.9, N), ("é", -3.0, N), ("▁ü", -2.9, N), ("<user>", -1.0, 4),
    ("▁▁", -5.0, N), ("d", -4.0, N), ("og", -2.5, N), ("do", -2.5, N),
    ("g", -4.0, N),
]
TEXTS = ["the quick brown fox", "the theft", "he thinks", "fox ox",
         "brownie", "q", "", " ", "unknown Ω char", "ΩΩ twice",
         "the ΩΩΩ fox", "éé mix Ωé", "über the", "two  spaces   three",
         " lead and trail ", "<user> the", "théé", "日本 the", "the dog"]
#: the tiny encoder
TINY = dict(vocab_size=50, d_model=16, d_kv=8, d_ff=32, num_layers=2,
            num_heads=2)


def test_sp_model_bytes_and_parse_equal_jax(tmp_path):
    """The written ModelProto is JAX's byte for byte, and both parsers read
    it (and a file of it) to the same pieces, scores and types."""
    blob = psp.write_sp_model(PIECES)
    assert blob == jsp.write_sp_model(PIECES)
    assert psp.parse_sp_model(blob) == jsp.parse_sp_model(blob)
    path = tmp_path / "spiece.model"
    path.write_bytes(blob)
    sp, ref = psp.SentencePieceUnigram(str(path)), \
        jsp.SentencePieceUnigram(str(path))
    assert (sp.pieces, sp.scores, sp.types, sp.index, sp.unk_id) == \
        (ref.pieces, ref.scores, ref.types, ref.index, ref.unk_id)
    assert sp.vocab_size == len(PIECES) and sp.unk_id == 2


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "bare"])
def test_sp_codec_equals_jax(prefix):
    """ids, pieces and decoded text on every fixture text, with and
    without the dummy prefix; an equal-score segmentation (``d``·``og``
    against ``do``·``g``) keeps JAX's tie-break; a run of unknown
    characters is one unknown token."""
    blob = psp.write_sp_model(PIECES)
    sp = psp.SentencePieceUnigram(blob, add_dummy_prefix=prefix)
    ref = jsp.SentencePieceUnigram(blob, add_dummy_prefix=prefix)
    for text in TEXTS:
        ids = sp.encode(text)
        assert ids == ref.encode(text), text
        assert sp(text) == ids
        assert sp.encode_pieces(text) == ref.encode_pieces(text), text
        assert sp.decode(ids) == ref.decode(ids), text
    assert sp.encode("ΩΩ twice").count(sp.unk_id) == 1
    assert sp.encode_pieces("dog")[-2:] in (["d", "og"], ["do", "g"])
    assert sp.decode([1, 2, 4, 99, -1]) == ref.decode([1, 2, 4, 99, -1])
    listed = psp.SentencePieceUnigram([p[:2] for p in PIECES],
                                      add_dummy_prefix=prefix)
    assert listed.encode("the ΩΩΩ fox") == jsp.SentencePieceUnigram(
        [p[:2] for p in PIECES],
        add_dummy_prefix=prefix).encode("the ΩΩΩ fox")


@pytest.mark.parametrize("length", [1, 77, 300])
def test_relative_position_bucket_equals_jax(length):
    pos = np.arange(length)
    rel = pos[None, :] - pos[:, None]
    got = pt5.relative_position_bucket(rel)
    want = jt5.relative_position_bucket(rel)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pt5.relative_position_bucket(rel, 16, 64),
        jt5.relative_position_bucket(rel, 16, 64))


def t5_params(model, ids, seed):
    """JAX's variables for ``model`` at ``ids``' shape, filled with seeded
    numpy; the RMS norms' weights around 1."""
    params = jax.tree.map(np.array, _random_params(
        jax.eval_shape(model.init, jax.random.PRNGKey(0), ids), seed=seed))

    def norms(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                norms(val)
            elif key == "weight":
                val[:] = 1.0 + val
    norms(params)
    return params


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
def test_t5_encoder_matches_jax(ff):
    """Both feed-forwards, on ids with a padded row (5 of 9 keys), with
    the mask and without; the tree loads strictly: ``rel_bias`` in block 0
    only, the norms' ``weight`` as they are."""
    cfg = dict(TINY, feed_forward=ff)
    jm = jt5.T5Encoder(jt5.T5Config(**cfg))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    params = t5_params(jm, ids, seed=4)
    assert "rel_bias" in params["params"]["block_0"]["attn"]
    assert "rel_bias" not in params["params"]["block_1"]["attn"]
    model = pt5.T5Encoder(pt5.T5Config(**cfg))
    load_jax_params(model, params)
    apply = jax.jit(jm.apply)
    with torch.no_grad():
        for m in (mask, None):
            want = apply(params, ids, m)
            got = model(torch.from_numpy(ids).long(),
                        None if m is None else torch.from_numpy(m))
            assert got.shape == (2, 9, 16)
            assert_close(got, want)
        # the mask matters: the padded row differs from the unmasked run
        assert float((got[1] - model(torch.from_numpy(ids).long(),
                                     torch.from_numpy(mask))[1]
                      ).abs().max()) > 1e-3


def test_t5_conditioner_encode_matches_jax():
    """``encode`` on texts of 0, 4 and more than ``max_length − 1`` tokens:
    the ids (pad 0, EOS 1 after the first ``max_length − 1`` tokens) and
    masks equal JAX's, the hidden states within 1e-5 of the largest; no
    tokenizer is JAX's ``RuntimeError``."""
    codec = psp.SentencePieceUnigram(psp.write_sp_model(PIECES))
    cfg = dict(TINY, vocab_size=len(PIECES))
    jcond = jt5.T5Conditioner(jt5.T5Config(**cfg), params={},
                              tokenizer=codec, max_length=12)
    params = t5_params(jcond.model, jnp.zeros((1, 12), jnp.int32), seed=6)
    jcond.params = params
    seen = {}
    program = jcond._fn()

    def recording(p, ids, mask):
        seen["ids"], seen["mask"] = np.asarray(ids), np.asarray(mask)
        return program(p, ids, mask)

    jcond._fn = lambda: recording
    texts = ["", "the quick fox",
             "the quick brown fox ox ox ox ox ox ox ox"]
    want = jcond.encode(texts)
    cond = pt5.T5Conditioner(pt5.T5Config(**cfg), params=params,
                             tokenizer=codec, max_length=12, device="cpu")
    ids, mask = cond.tokenize(texts)
    np.testing.assert_array_equal(ids, seen["ids"])
    np.testing.assert_array_equal(mask, seen["mask"])
    assert ids[0, 0] == 1 and mask.sum(1).tolist() == [1, 5, 12]
    assert ids[2, -1] == 1
    got = cond.encode(texts)
    assert got.device.type == "cpu" and got.shape == (3, 12, 16)
    assert_close(got, want)
    with pytest.raises(RuntimeError, match="no tokenizer"):
        pt5.T5Conditioner(pt5.T5Config(**cfg), device="cpu").encode(["a"])
