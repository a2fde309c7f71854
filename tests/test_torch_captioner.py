"""The port's audio captioner (``models/caption/captioner.py``) and
``CaptionEngine`` against the JAX package on shared weights
(``load_jax_params``), at a tiny width: the decoder logits, and the greedy
and beam-3 ids on the weights of two seeds, exactly, in a batch of two
lengths (one row stops early)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.caption import captioner as jcap
from audiogpt_tpu.models.caption.cnn14 import Cnn14Config as JaxCnn14Config
from audiogpt_tpu_torch.engines import CaptionEngine
from audiogpt_tpu_torch.models.caption import captioner as pcap
from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config
from test_torch_analysis import CHANNELS, _close, _ported, _wav
from test_torch_cnn14 import random_variables

torch.set_num_threads(2)

CAPTION = dict(rnn_hidden=8, vocab_size=40, emb_dim=16, nhead=2, nlayers=2,
               dim_feedforward=32, max_caption_len=8)
#: added to the EOS logit's bias: greedy decode of the seed-2 weights then
#: stops at step 4 in one row and not in the other
EOS_BIAS = 1.0


def _caption_cfg(mod, cnn):
    return mod.CaptionConfig(cnn14=cnn(channels=CHANNELS), **CAPTION)


@pytest.fixture(scope="module")
def caption():
    """The JAX and port captioners on the variables of two seeds, the EOS
    logit raised by ``EOS_BIAS``."""
    jmodel = jcap.CaptionModel(_caption_cfg(jcap, JaxCnn14Config))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32000)), jnp.zeros((1, 4),
                                                             jnp.int32))
    out = []
    for seed in (2, 4):
        variables = random_variables(shapes, seed)
        variables["params"]["classifier"]["bias"][9] += EOS_BIAS
        model = _ported(pcap.CaptionModel(_caption_cfg(pcap, Cnn14Config)),
                        variables)
        out.append((variables, model))
    return jmodel, out


def test_caption_decode_logits_match_jax(caption):
    jmodel, [(variables, model), _] = caption
    rng = np.random.RandomState(4)
    memory = rng.randn(2, 5, 16).astype(np.float32)
    mem_len = np.asarray([5, 3], np.int32)
    words = rng.randint(0, CAPTION["vocab_size"], (2, 8)).astype(np.int32)
    ref = jax.jit(lambda v, w, m, n: jmodel.apply(
        v, w, m, n, method=jcap.CaptionModel.decode_logits))(
        variables, words, memory, mem_len)
    with torch.no_grad():
        got = model.decode_logits(torch.from_numpy(words).long(),
                                  torch.from_numpy(memory),
                                  torch.from_numpy(mem_len).long())
    _close(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_caption_greedy_and_beam_ids_equal_jax(caption, seed):
    jmodel, models = caption
    variables, model = models[seed]
    wav = _wav(2, 40000, seed=5 + seed)
    wav_len = np.asarray([40000, 25000], np.int32)
    jargs = (jnp.asarray(wav), jnp.asarray(wav_len))
    args = (torch.from_numpy(wav), torch.from_numpy(wav_len))
    greedy = pcap.caption_greedy_decode(model, *args).numpy()
    beam = pcap.caption_beam_decode(model, *args, beam_size=3).numpy()
    np.testing.assert_array_equal(
        greedy, jcap.caption_greedy_decode(jmodel, variables, *jargs))
    np.testing.assert_array_equal(
        beam, jcap.caption_beam_decode(jmodel, variables, *jargs,
                                       beam_size=3))
    # the random net emits words, not one token alone
    assert len(np.unique(np.concatenate([greedy, beam])[:, 1:])) > 2


def test_caption_engine_pads_to_its_bucket_and_decodes_words(caption):
    _, [(variables, model), _] = caption
    cfg = _caption_cfg(pcap, Cnn14Config)
    eng = CaptionEngine(cfg, params=variables, max_sec=4.0,
                        vocab=[f"w{i}" for i in range(40)], device="cpu")
    assert eng.bucketer.buckets == (64000, 128000)
    wav = _wav(1, 40000, seed=5)
    padded = torch.zeros(1, 64000)
    padded[0, :40000] = torch.from_numpy(wav[0])
    want = pcap.caption_greedy_decode(model, padded,
                                      torch.tensor([40000]))[0].numpy()
    np.testing.assert_array_equal(eng.caption_tokens(wav[0]), want)
    body = want[1:]
    if (body == cfg.eos_id).any():
        body = body[: np.flatnonzero(body == cfg.eos_id)[0]]
    assert eng.caption(wav[0]) == " ".join(f"w{t}" for t in body)
    assert isinstance(eng.caption_beam(wav[0]), str)
    assert set(eng.timings) == {"caption"}
