"""The BLIP captioner (``audiogpt_tpu_torch/models/caption/blip.py``) and
``ImageCaptionEngine`` (``engines/analysis.py``) against the JAX package on
shared parameters, at ``tests/test_engines.py``'s tiny config: the vision
tower, the teacher-forced logits, the cached decode steps, the greedy
token ids (exactly, with rows that
stop at different steps) and the caption strings with and without a vocab
file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.analysis import \
    ImageCaptionEngine as JaxImageCaptionEngine
from audiogpt_tpu.models.caption import blip as jblip
from audiogpt_tpu.ops.attention import KVCache as JaxKVCache
from audiogpt_tpu_torch.engines import ImageCaptionEngine
from audiogpt_tpu_torch.models.caption import blip as pblip
from audiogpt_tpu_torch.ops.attention import KVCache
from test_torch_t2a import _random_params

torch.set_num_threads(2)

VISION = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2,
              mlp_dim=64)
TEXT = dict(vocab_size=60, width=32, layers=1, heads=2, mlp_dim=64,
            encoder_width=32, bos_id=58, eos_id=59)
MAX_TOKENS = 5
#: added to the EOS logit's bias: greedy decode of ``_images(4, seed=13)``
#: then stops at step 0 in one row, at step 1 in another and not at all in
#: two
EOS_BIAS = 0.5


def _cfgs(mod):
    return mod.BlipConfig(vision=mod.BlipVisionConfig(**VISION),
                          text=mod.BlipTextConfig(**TEXT))


@pytest.fixture(scope="module")
def params():
    model = jblip.BlipCaptioner(_cfgs(jblip))
    tree = _random_params(jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 2), jnp.int32)), seed=11)
    tree["params"]["decoder"]["head_out"]["bias"][TEXT["eos_id"]] += EOS_BIAS
    return tree


@pytest.fixture(scope="module")
def models(params):
    jmodel = jblip.BlipCaptioner(_cfgs(jblip))
    model = pblip.BlipCaptioner(_cfgs(pblip)).eval()
    from audiogpt_tpu_torch.utils.jax_params import load_jax_params

    load_jax_params(model, params)
    return jmodel, model


def _jit(jmodel, method):
    """A compiled ``jmodel.apply`` of ``method`` (one XLA program: the
    flax module applied op by op on the CPU takes seconds longer)."""
    return jax.jit(lambda params, *args: jmodel.apply(params, *args,
                                                      method=method))


def _images(n, seed=12):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def test_vision_encoder_matches_jax(params, models):
    jmodel, model = models
    x = _images(2)
    ref = _jit(jmodel, jblip.BlipCaptioner.encode_image)(params,
                                                         jnp.asarray(x))
    with torch.inference_mode():
        got = model.encode_image(torch.from_numpy(x))
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_decode_steps_match_jax(params, models):
    """The BOS step and one cached step after it: logits of the static
    cache under its valid-length mask, on image K/V projected once."""
    jmodel, model = models
    x = _images(2)
    img = _jit(jmodel, jblip.BlipCaptioner.encode_image)(params,
                                                         jnp.asarray(x))
    jcross = _jit(jmodel, jblip.BlipCaptioner.cross_kvs)(params, img)
    jcaches = [JaxKVCache.create(2, 3, 2, 16)]
    bos = np.full((2, 1), TEXT["bos_id"], np.int32)
    tok = np.asarray([[7], [31]], np.int32)
    step = _jit(jmodel, jblip.BlipCaptioner.decode_step)
    ref0, jcaches = step(params, jnp.asarray(bos), jcross, 0, jcaches)
    ref1, _ = step(params, jnp.asarray(tok), jcross, 1, jcaches)
    with torch.inference_mode():
        cross = model.cross_kvs(torch.from_numpy(np.asarray(img)))
        caches = [KVCache.create(2, 3, 2, 16)]
        got0 = model.decode_step(torch.from_numpy(bos).long(), cross, 0,
                                 caches)
        got1 = model.decode_step(torch.from_numpy(tok).long(), cross, 1,
                                 caches)
    assert caches[0].index == 2
    for got, ref in ((got0, ref0), (got1, ref1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_teacher_forced_logits_match_jax(params, models):
    """The uncached path: causal self-attention over the whole token row
    and cross-attention on the image states, as for training."""
    jmodel, model = models
    x = _images(2)
    toks = np.random.RandomState(14).randint(0, 60, (2, 6)).astype(np.int32)
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(toks))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(toks).long())
    assert got.shape == (2, 6, 60)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_greedy_ids_equal_jax(params, models):
    """Exact token ids; the rows stop at different steps, and a stopped
    row feeds EOS, as the JAX scan does."""
    jmodel, model = models
    x = _images(4, seed=13)
    ref = np.asarray(jblip.greedy_caption(jmodel, params, jnp.asarray(x),
                                          MAX_TOKENS))
    got = pblip.greedy_caption(model, torch.from_numpy(x), MAX_TOKENS)
    np.testing.assert_array_equal(got.numpy(), ref)
    eos = TEXT["eos_id"]
    stops = {int(np.argmax(row[1:] == eos)) if (row == eos).any() else None
             for row in ref}
    assert len(stops) > 1, ref      # the rows stop at different steps


def _vocab(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [
        f"w{i}" for i in range(54)] + ["[DEC]", "[ENC]"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    return str(path)


@pytest.mark.parametrize("with_vocab", [False, True])
def test_caption_strings_equal_jax(params, tmp_path, with_vocab):
    """The engines' captions of one PNG by path (PIL bicubic to 32, BLIP
    normalisation), cut at the first EOS and decoded with the same
    WordPiece vocab: a vocab file, or none (``<id>`` placeholders)."""
    from PIL import Image

    vocab = _vocab(tmp_path) if with_vocab else None
    cfg = _cfgs(jblip)
    jeng = JaxImageCaptionEngine(cfg, params=params, vocab_path=vocab,
                                 max_tokens=MAX_TOKENS)
    eng = ImageCaptionEngine(_cfgs(pblip), params=params, vocab_path=vocab,
                             max_tokens=MAX_TOKENS, media_root=str(tmp_path),
                             device="cpu")
    for seed in (1, 2, 3):
        path = tmp_path / f"x{seed}.png"
        Image.fromarray((np.random.RandomState(seed).rand(20, 28, 3) * 255)
                        .astype(np.uint8)).save(path)
        np.testing.assert_array_equal(
            pblip.preprocess_image(str(path), 32),
            jblip.preprocess_image(str(path), 32))
        got = eng(str(path))
        assert got == jeng(str(path))
        assert "[DEC]" not in got and "[SEP]" not in got
    assert "i2t" in eng.timings


def test_relative_path_is_read_under_media_root(params, tmp_path):
    from PIL import Image

    (tmp_path / "image").mkdir()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(
        tmp_path / "image" / "a.png")
    eng = ImageCaptionEngine(_cfgs(pblip), params=params,
                             max_tokens=MAX_TOKENS, media_root=str(tmp_path),
                             device="cpu")
    assert eng("image/a.png") == eng(str(tmp_path / "image" / "a.png"))


def test_engine_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ImageCaptionEngine(_cfgs(pblip))
