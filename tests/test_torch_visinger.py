"""Port VISinger (``audiogpt_tpu_torch/models/svs/visinger.py``) and
``VISingerEngine`` (``engines/svs.py``) against the JAX package on shared
parameters and replayed draws: the coupling flow both ways and its round
trip, inference from note durations, and the engine
on a score whose phones carry their word's whole duration, as in JAX.

VISinger's coupling ``post`` layers, zero-initialised in JAX, get random
values on both sides (``_random_params``), or the flow would be the
identity and the comparison would show nothing. The score's durations are
whole frame counts, so no rounded duration sits near its rounding edge.
Tolerances: module outputs within 1e-4 absolute, the wav within 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines import svs as jsvs
from audiogpt_tpu.models.svs import visinger as jvis
from audiogpt_tpu.models.vocoder import hifigan as jh
from audiogpt_tpu_torch.engines import svs
from audiogpt_tpu_torch.models.svs import visinger as pvis
from audiogpt_tpu_torch.models.vocoder import hifigan as ph
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_svs import ATOL, SAMPLE_ATOL, SONG, init_params, to_torch

torch.set_num_threads(2)

VIS = dict(vocab_size=64, hidden=16, enc_layers=1, enc_heads=2,
           latent_dim=8, spec_bins=9, posterior_layers=1, flow_layers=2,
           flow_wn_layers=2, max_frames=64)
HIFI = dict(in_channels=8, upsample_initial_channel=16,
            upsample_rates=(16,), upsample_kernel_sizes=(32,),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
#: 20 frames a second at the tiny decoder's hop of 16: the song's
#: durations are whole frame counts
SR = 320


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, params) on shared parameters."""
    jcfg = jvis.VISingerConfig(**VIS, decoder=jh.HifiGANConfig(**HIFI))
    pcfg = pvis.VISingerConfig(**VIS, decoder=ph.HifiGANConfig(**HIFI))
    t = jnp.ones((1, 4), jnp.int32)
    params = init_params(jvis.VISinger(jcfg), t, t * 60, t * 0,
                         rng=jax.random.PRNGKey(0), seed=8)
    assert np.abs(params["params"]["flow"]["l0"]["post"]["kernel"]).max() > 0
    return (jsvs.VISingerEngine(jcfg, params=params, token_buckets=(16,),
                                sample_rate=SR),
            svs.VISingerEngine(pcfg, params=params, token_buckets=(16,),
                               sample_rate=SR, device="cpu"), params)


def test_flow_matches_jax(engines):
    """The coupling flow both ways and its round trip."""
    jeng, eng, params = engines
    rng = np.random.RandomState(7)
    z = rng.randn(2, 20, 8).astype(np.float32)
    mask = np.ones((2, 20), np.float32)
    mask[1, 13:] = 0.0

    def both(s, z, mask):
        return s.flow(z, mask), s.flow(z, mask, reverse=True)

    fwd, rev = jax.jit(lambda p, *a: jeng.model.apply(
        p, *a, method=both))(params, z, mask)
    model, m = eng.model, to_torch(mask)
    with torch.no_grad():
        got_fwd = model.flow(to_torch(z), m)
        got_rev = model.flow(to_torch(z), m, reverse=True)
        back = model.flow(got_fwd, m, reverse=True)
    np.testing.assert_allclose(got_fwd.numpy(), fwd, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_rev.numpy(), rev, atol=ATOL, rtol=0)
    assert np.abs(np.asarray(rev) - z).max() > 0.1
    np.testing.assert_allclose(back.numpy(), z * mask[..., None], atol=ATOL,
                               rtol=0)


def test_visinger_matches_jax(engines):
    """Inference from note durations (3 frames a token) with the prior's
    draw replayed, through the JAX engine's compiled ``VISinger.apply``."""
    jeng, eng, params = engines
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = np.random.RandomState(1).randint(3, 60, 11)
    midi = np.where(toks > 0, 60 + np.arange(16) % 7, 0).astype(np.int32)
    slur = np.where(toks > 0, np.arange(16) % 4 == 3, 0).astype(np.int32)
    dur = np.where(toks > 0, 0.15, 0.0).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jeng._fn(params, toks, midi, dur, slur, key)
    with torch.no_grad():
        got = eng.model(to_torch(toks).long(), to_torch(midi).long(),
                        to_torch(slur).long(), note_durs=to_torch(dur),
                        frames_per_sec=eng.frames_per_sec,
                        draws=to_torch(jax.random.normal(
                            key, (1, VIS["max_frames"], 8))))
    np.testing.assert_array_equal(got["mel2ph"].numpy(), ref["mel2ph"])
    assert int((ref["mel2ph"] > 0).sum()) == 33
    assert np.abs(ref["wav"]).max() > 0.01
    np.testing.assert_allclose(got["wav"].numpy(), ref["wav"],
                               atol=SAMPLE_ATOL, rtol=0)


def test_visinger_engine_matches_jax(engines):
    jeng, eng, _ = engines
    jeng._rng = jax.random.PRNGKey(0)
    ref = jeng.synthesize(*SONG)
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    got = eng.synthesize(*SONG, draws=to_torch(jax.random.normal(
        rng, (1, VIS["max_frames"], 8))))
    # 2+2+6+6+4+5+4+4+3+3+6 frames: each phone of a word carries the
    # word's whole duration, as in JAX
    assert got.dtype == np.float32
    assert got.shape == ref.shape == (45 * 16,)
    np.testing.assert_allclose(got, ref, atol=SAMPLE_ATOL, rtol=0)
    assert eng.frames_per_sec == jeng.frames_per_sec == SR / 16
