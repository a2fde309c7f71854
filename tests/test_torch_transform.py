"""The port's audio transform tools against the JAX package on shared
weights (``load_jax_params``), at tiny widths: LASSNet's mask and
``ExtractionEngine.extract``, Conv-TasNet with and without a valid length
and ``separate_streaming`` (a clip shorter than a segment, and one of two
chunks), a tiny SkiM, the binaural network and ``binauralize_chunked`` over
two chunks, and the engines' device rule. Each JAX program compiles once:
the tests share the jitted applies of the JAX modules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.dsp.stft import istft as jax_istft
from audiogpt_tpu.dsp.stft import stft as jax_stft
from audiogpt_tpu.engines.transform import BinauralEngine as JaxBinauralEngine
from audiogpt_tpu.models.binaural import binaural as jbin
from audiogpt_tpu.models.extraction import lassnet as jlass
from audiogpt_tpu.models.separation import convtasnet as jtas
from audiogpt_tpu.models.separation import skim as jskim
from audiogpt_tpu.models.textenc.bert import BertConfig as JaxBertConfig
from audiogpt_tpu_torch.engines import (BinauralEngine, ExtractionEngine,
                                        SeparationEngine)
from audiogpt_tpu_torch.models.binaural import binaural as pbin
from audiogpt_tpu_torch.models.extraction import lassnet as plass
from audiogpt_tpu_torch.models.separation import convtasnet as ptas
from audiogpt_tpu_torch.models.separation import skim as pskim
from audiogpt_tpu_torch.models.textenc import BertConfig
from test_torch_analysis import _close, _ported
from test_torch_cnn14 import random_variables

torch.set_num_threads(2)

#: BERT at the bundled vocab's size, so both tokenizers load it
BERT = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
#: three U-Net levels (the app's six trace for seconds longer in flax)
LASS = dict(cond_dim=16, enc_channels=(4, 8, 8))
TASNET = dict(n_src=2, enc_dim=32, enc_kernel=16, bottleneck=16, hidden=32,
              skip=16, n_blocks=3, n_repeats=1)
SKIM = dict(n_src=2, enc_dim=16, hidden=8, segment_size=10, n_blocks=2)
BINAURAL = dict(warpnet_channels=8)
LASS_FRAMES = 256         # the extraction engine's first bucket
#: the extraction engine's STFT, narrowed: 129 bins (127 in the U-Net)
N_FFT, HOP = 256, 64


def _noise(n, seed, sr=16000):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    return (0.1 * rng.randn(n) + 0.3 * np.sin(2 * np.pi * 300 * t)
            + 0.2 * np.sin(2 * np.pi * 1100 * t)).astype(np.float32)


# -- extraction ---------------------------------------------------------------

@pytest.fixture(scope="module")
def lass():
    """The JAX LASSNet's variables and its jitted apply at [1, 256, 129]."""
    cfg = jlass.LASSNetConfig(bert=JaxBertConfig(**BERT), **LASS)
    jmodel = jlass.LASSNet(cfg)
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, LASS_FRAMES, N_FFT // 2 + 1)),
        jnp.zeros((1, 64), jnp.int32), jnp.ones((1, 64), jnp.int32)), seed=1)
    return variables, jax.jit(jmodel.apply)


def _lass_cfg():
    return plass.LASSNetConfig(bert=BertConfig(**BERT), **LASS)


def test_lassnet_mask_matches_jax(lass):
    variables, apply = lass
    rng = np.random.RandomState(2)
    sp = np.abs(rng.randn(1, LASS_FRAMES, N_FFT // 2 + 1)).astype(np.float32)
    ids = rng.randint(0, 30522, (1, 64)).astype(np.int32)
    mask = (np.arange(64) < 9).astype(np.int32)[None]
    ref = apply(variables, sp, ids, mask)
    model = _ported(plass.LASSNet(_lass_cfg()), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(sp), torch.from_numpy(ids).long(),
                    torch.from_numpy(mask))
    assert got.shape == (1, LASS_FRAMES, N_FFT // 2 + 1)
    # the two dropped bins come back as logit 0
    np.testing.assert_array_equal(got[..., -2:].numpy(), 0.5)
    _close(got, ref)


def test_extraction_engine_matches_jax(lass):
    """``ExtractionEngine.extract`` against the JAX engine's steps
    (``audiogpt_tpu/engines/transform.py:60-71``): STFT, the mask on the
    padded magnitude, the mixture phase, iSTFT to the input's length."""
    variables, apply = lass
    eng = ExtractionEngine(_lass_cfg(), params=variables, n_fft=N_FFT,
                           hop=HOP, max_sec=1.0, device="cpu")
    wav = _noise(10000, seed=3, sr=32000)        # 157 frames → bucket 256
    text = "a dog barking"
    spec = jax_stft(jnp.asarray(wav), N_FFT, HOP)
    mag = np.abs(np.asarray(spec))
    padded = np.pad(mag, ((0, LASS_FRAMES - len(mag)), (0, 0)))[None]
    ids, mask = eng.tokenizer.encode(text, 64)
    m = np.asarray(apply(variables, padded, ids[None], mask[None]))[0, :157]
    want = np.asarray(jax_istft(jnp.asarray(m) * spec, N_FFT, HOP,
                                length=len(wav)))
    got = eng.extract(wav, text)
    assert got.shape == wav.shape and float(np.abs(got).max()) > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert set(eng.timings) == {"extraction"}


# -- separation ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tasnet():
    """The JAX Conv-TasNet, its variables, and the JAX package's own
    batched program (``_sep_fn``), which ``separate_streaming`` runs."""
    jmodel = jtas.ConvTasNet(jtas.ConvTasNetConfig(**TASNET))
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 4000))), seed=4)
    model = _ported(ptas.ConvTasNet(ptas.ConvTasNetConfig(**TASNET)),
                    variables)
    return jmodel, variables, model


def test_convtasnet_matches_jax_with_and_without_valid_len(tasnet):
    jmodel, variables, model = tasnet
    wav = np.stack([_noise(4000, 5), _noise(4000, 6)])
    wav[1, 2500:] = 0.0
    valid = np.asarray([4000, 2500], np.int32)
    with torch.no_grad():
        for lens in (None, valid):
            ref = jax.jit(jmodel.apply)(
                variables, wav, None if lens is None else jnp.asarray(lens))
            got = model(torch.from_numpy(wav), None if lens is None
                        else torch.from_numpy(lens))
            assert got.shape == (2, 2, 4000)
            _close(got, ref)
    # the valid length keeps the padding out of the norms: row 1's real
    # samples differ from an unmasked run
    with torch.no_grad():
        unmasked = model(torch.from_numpy(wav))[1, :, :2500]
        masked = model(torch.from_numpy(wav),
                       torch.from_numpy(valid))[1, :, :2500]
    assert float((unmasked - masked).abs().max()) > 1e-4


@pytest.mark.parametrize("seconds", [0.3, 3.0])
def test_separate_streaming_matches_jax(tasnet, seconds):
    """0.3 s: one call on the 8192-sample bucket; 3 s: two 2.4 s chunks
    0.8 s apart in one batch of 2, overlap-added."""
    jmodel, variables, model = tasnet
    wav = _noise(int(16000 * seconds), seed=7)
    want = jtas.separate_streaming(jmodel, variables, wav)
    got = ptas.separate_streaming(model, wav)
    assert got.shape == want.shape == (2, len(wav))
    _close(got, want)


def test_skim_matches_jax():
    wav = np.stack([_noise(4000, 8), _noise(4000, 9)])
    jmodel = jskim.SkiM(jskim.SkiMConfig(**SKIM))
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), wav), seed=10)
    ref = jax.jit(jmodel.apply)(variables, wav)
    model = _ported(pskim.SkiM(pskim.SkiMConfig(**SKIM)), variables)
    eng = SeparationEngine(model=model, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(wav))
    # 500 frames in 50 segments of 10, two blocks of segment and memory
    # LSTMs
    assert got.shape == (2, 2, 4000)
    _close(got, ref)
    assert eng.cfg.n_src == 2 and eng.separate(wav[0]).shape == (2, 4000)
    assert eng.enhance(wav[0]).shape == (4000,)
    assert set(eng.timings) == {"separation"}


# -- binaural -----------------------------------------------------------------

def _view(n_view, seed):
    rng = np.random.RandomState(seed)
    view = 0.3 * rng.randn(7, n_view).astype(np.float32)
    view[0] += 1.0               # about 1 m in front
    view[3:] += np.asarray([0.1, 0.2, 0.0, 1.0], np.float32)[:, None]
    return view


def test_binaural_network_and_chunks_match_jax():
    cfg = jbin.BinauralConfig(**BINAURAL)
    jmodel = jbin.BinauralNetwork(cfg)
    t = 48000 + 4000             # a 1 s chunk, then a tail with its halo
    mono = _noise(t, seed=11, sr=48000)
    view = _view(t // 400, seed=12)
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 800)),
        jnp.zeros((1, 7, 2))), seed=13)
    eng = BinauralEngine(pbin.BinauralConfig(**BINAURAL), params=variables,
                         device="cpu")
    # the geometric warpfield (delays of ~140 samples): 1e-5 of its largest
    _close(pbin.geometric_warpfield(torch.from_numpy(view[None]), 4000,
                                    48000),
           jbin.geometric_warpfield(jnp.asarray(view[None]), 4000, 48000),
           tol=1e-5 * 140)
    want = jbin.binauralize_chunked(jmodel, variables, mono, view)
    got = eng.binauralize(mono, view)
    assert got.shape == want.shape == (2, t)
    # a read position is an f32 below 48 000: the frameworks may round it
    # one ulp apart, which moves the output by that ulp times the signal's
    # largest step between neighbouring samples (each way)
    tol = 2 * float(np.spacing(np.float32(48000))) \
        * float(np.abs(np.diff(mono)).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the default trajectory: JAX's 1 m orbit
    jeng = JaxBinauralEngine(cfg, params=variables)
    np.testing.assert_array_equal(eng.default_trajectory(5),
                                  jeng.default_trajectory(5))
    assert set(eng.timings) == {"binaural"}


def test_engines_need_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in (ExtractionEngine, SeparationEngine, BinauralEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine()
