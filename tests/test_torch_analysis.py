"""The port's audio analysis tools against the JAX package on shared
weights (``load_jax_params``), at tiny widths: the GRU at every position,
the PANN SED net, a tiny PVT SED net, the TSD net with its upsampled decision
and decoded spans, ``TSDEngine.detect`` and ``SEDEngine.plot``'s panel
data against the JAX engines' steps, and the engines' device rule. Each
JAX program compiles once (a jitted apply at one shape serves the model
and the engine test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiogpt_tpu.dsp.stft import stft as jax_stft
from audiogpt_tpu.dsp.mel import log_mel as jax_log_mel
from audiogpt_tpu.models.caption.cnn14 import Cnn14Config as JaxCnn14Config
from audiogpt_tpu.models.sed import panns_sed as jsed
from audiogpt_tpu.models.sed import pvt as jpvt
from audiogpt_tpu.models.sed import tsd as jtsd
from audiogpt_tpu.ops.rnn import GRU as JaxGRU
from audiogpt_tpu_torch.engines import CaptionEngine, SEDEngine, TSDEngine
from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config
from audiogpt_tpu_torch.models.sed import panns_sed as psed
from audiogpt_tpu_torch.models.sed import pvt as ppvt
from audiogpt_tpu_torch.models.sed import tsd as ptsd
from audiogpt_tpu_torch.models.textenc import BertConfig, CLAPTextConfig
from audiogpt_tpu_torch.ops.rnn import GRU
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_cnn14 import random_variables

torch.set_num_threads(2)

CHANNELS = (4, 4, 8, 8, 16, 16)
PVT = dict(classes_num=10, embed_dims=(8, 16, 16, 16), depths=(1, 1, 1, 1),
           num_heads=(1, 2, 2, 2), mlp_ratios=(2, 2, 2, 2),
           sr_ratios=(8, 4, 2, 1))
TSD = dict(mel_bins=64, embedding_dim=8, gru_hidden=8, channels=(4, 4, 8, 8))
#: BERT at the bundled vocab's size, so both tokenizers load it
BERT = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)


def _wav(batch, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 32000.0
    return (0.3 * rng.randn(batch, n)
            + 0.5 * np.sin(2 * np.pi * 660.0 * t)).astype(np.float32)


def _close(got, want, tol=1e-5):
    """Within ``tol`` of the larger of 1 and the reference's largest
    value."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _ported(model, variables):
    load_jax_params(model, variables)
    return model.eval()


# -- GRU --------------------------------------------------------------------

def test_gru_matches_jax_at_every_position():
    x = np.random.RandomState(0).randn(3, 7, 6).astype(np.float32)
    lengths = np.asarray([7, 4, 1], np.int32)
    jgru = JaxGRU(5, bidirectional=True)
    variables = random_variables(jax.eval_shape(
        jgru.init, jax.random.PRNGKey(0), x), seed=1)
    gru = _ported(GRU(6, 5, bidirectional=True), variables)
    fwd_only = GRU(6, 5)
    fwd_only.fwd.load_state_dict(gru.fwd.state_dict())
    apply = jax.jit(jgru.apply)
    with torch.no_grad():
        for lens in (None, lengths):
            ref = apply(variables, x, None if lens is None
                        else jnp.asarray(lens))
            got = gru(torch.from_numpy(x), None if lens is None
                      else torch.from_numpy(lens))
            # f32 recurrences of 7 steps: 1e-5
            _close(got, ref)
        # the unidirectional GRU is the forward half
        _close(fwd_only(torch.from_numpy(x)), np.asarray(ref)[..., :5])


# -- sound-event detection ---------------------------------------------------

SED_SAMPLES = 64000       # the first bucket of a 4 s engine


@pytest.fixture(scope="module")
def sed():
    """The JAX SED net's variables and its jitted apply at [1, 64000]."""
    jmodel = jsed.SEDModel(jsed.SEDConfig(
        cnn14=JaxCnn14Config(channels=CHANNELS)))
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SED_SAMPLES)),
        jnp.asarray([SED_SAMPLES])), seed=7)
    return variables, jax.jit(jmodel.apply)


def _sed_input(n):
    wav = _wav(1, n, seed=6)
    padded = np.zeros((1, SED_SAMPLES), np.float32)
    padded[:, :n] = wav
    return wav[0], padded, np.asarray([n], np.int32)


def test_sed_model_matches_jax(sed):
    variables, apply = sed
    _, padded, n = _sed_input(48000)
    ref = apply(variables, padded, n)
    model = _ported(psed.SEDModel(psed.SEDConfig(
        cnn14=Cnn14Config(channels=CHANNELS))), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(padded), torch.from_numpy(n).long())
    # 201 mel frames → 6 after five pools → 192
    assert got["framewise_output"].shape == (1, 192, 527)
    for key in ("framewise_output", "clipwise_output", "embedding"):
        _close(got[key], ref[key])


def test_pvt_sed_matches_jax():
    wav = _wav(1, 32000, seed=8)
    jmodel = jpvt.PVTSED(jpvt.PVTConfig(**PVT))
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), wav), seed=9)
    ref = jax.jit(jmodel.apply)(variables, wav)
    model = _ported(ppvt.PVTSED(ppvt.PVTConfig(**PVT)), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(wav))
    # 101 mel frames: 25 x 16 tokens at stage 0, 3 x 2 keys
    assert got["framewise_output"].shape == (1, 101, 10)
    for key in ("framewise_output", "clipwise_output", "embedding"):
        _close(got[key], ref[key])


def test_audioset_labels_are_the_packages_own_copy():
    assert psed.audioset_labels() == jsed.audioset_labels()
    assert len(psed.audioset_labels()) == 527


def test_sed_plot_panels_match_jax_and_png_is_written(sed, tmp_path):
    from PIL import Image

    variables, apply = sed
    eng = SEDEngine(psed.SEDConfig(cnn14=Cnn14Config(channels=CHANNELS)),
                    params=variables, max_sec=4.0, device="cpu")
    wav, padded, n = _sed_input(48000)
    # the JAX engine's framewise and figure data
    # (``audiogpt_tpu/engines/analysis.py:119-149``)
    fw = np.asarray(apply(variables, padded, n)["framewise_output"])[0, :150]
    order = np.argsort(fw.max(axis=0))[::-1][:10]
    spec = np.abs(np.asarray(jax_stft(wav, 1024, 320))).T
    panels = eng.plot_panels(wav)
    np.testing.assert_array_equal(panels["order"], order)
    assert panels["labels"] == [jsed.audioset_labels()[i] for i in order]
    _close(panels["matrix"], fw[:, order])
    assert panels["spec"].shape == spec.shape == (513, 151)
    # the log of the magnitude: compared as magnitudes, 1e-5 of the largest
    _close(np.exp(panels["spec"]), np.maximum(spec, 1e-8),
           tol=1e-5 * spec.max())
    assert panels["fps"] == 100.0
    out = str(tmp_path / "sed.png")
    assert eng.plot(wav, out) == out
    with Image.open(out) as im:
        assert im.size == (1000, 400) and im.mode == "RGB"
        assert len(np.unique(np.asarray(im).reshape(-1, 3), axis=0)) > 20
    assert set(eng.timings) == {"sed"}
    events = eng.detect(wav, top_k=3)
    assert [e["label"] for e in events] == panels["labels"][:3]


# -- target-sound detection -------------------------------------------------

TSD_FRAMES = 256          # the TSD engine's first mel bucket


@pytest.fixture(scope="module")
def tsd():
    """The JAX TSD net's variables and its jitted apply at [1, 256, 64]."""
    jmodel = jtsd.TSDModel(jtsd.TSDConfig(**TSD))
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, TSD_FRAMES, 64)), jnp.zeros((1, 8))), seed=11)
    return variables, jax.jit(jmodel.apply)


def test_tsd_model_and_spans_match_jax(tsd):
    variables, apply = tsd
    rng = np.random.RandomState(10)
    mel = rng.randn(1, TSD_FRAMES, 64).astype(np.float32)
    emb = rng.randn(1, 8).astype(np.float32)
    ref_t, ref_up = apply(variables, mel, emb)
    model = _ported(ptsd.TSDModel(ptsd.TSDConfig(**TSD)), variables)
    with torch.no_grad():
        got_t, got_up = model(torch.from_numpy(mel), torch.from_numpy(emb))
    assert got_up.shape == (1, TSD_FRAMES, 2) and got_t.shape == (1, 32)
    _close(got_t, ref_t)
    _close(got_up, ref_up)
    probs, jprobs = got_up[0, :, 0].numpy(), np.asarray(ref_up[0, :, 0])
    thr = float(np.median(jprobs))
    spans = ptsd.decode_timestamps(probs, 100.0, 3, thr)
    assert spans and spans == jtsd.decode_timestamps(jprobs, 100.0, 3, thr)


@pytest.mark.parametrize("t,size", [(12, 96), (7, 50), (5, 5)])
def test_linear_upsampling_equals_jax_resize_at_the_edges(t, size):
    """``F.interpolate(linear, align_corners=False)`` is
    ``jax.image.resize(linear)`` for upsampling, first and last samples
    included (both clamp to the edge sample)."""
    x = np.random.RandomState(t).randn(2, 3, t).astype(np.float32)
    want = jax.image.resize(x, (2, 3, size), method="linear")
    got = F.interpolate(torch.from_numpy(x), size=size, mode="linear",
                        align_corners=False)
    _close(got, want, tol=1e-6)


def test_tsd_engine_detect_matches_jax(tsd):
    """``TSDEngine.detect`` against the JAX engine's steps
    (``audiogpt_tpu/engines/analysis.py:226-235``) on the port's query
    embedding (the CLAP tower's parity is ``test_torch_clap_text.py``'s)."""
    variables, apply = tsd
    eng = TSDEngine(ptsd.TSDConfig(**TSD), CLAPTextConfig(
        bert=BertConfig(**BERT), d_proj=16, max_length=16), params=variables,
        max_sec=4.0, device="cpu")
    wav = _wav(1, 33075, seed=14)[0]     # 1.5 s at 22.05 kHz: 130 frames
    text = "a dog barking"
    emb = eng.embed_text(text)
    assert emb.shape == (1, 8)
    m = np.asarray(jax_log_mel(jnp.asarray(wav), eng.mel))
    padded = np.pad(m, ((0, TSD_FRAMES - len(m)), (0, 0)))[None]
    jprobs = np.asarray(apply(variables, padded, emb.numpy())[1])[0, :130, 0]
    probs = eng.decision(wav, text)
    _close(probs, jprobs)
    thr = float(np.median(jprobs))
    want = jtsd.decode_timestamps(
        jtsd.median_filter(jprobs[:, None], 7, thr)[:, 0],
        eng.mel.sr / eng.mel.hop)
    assert want and eng.detect(wav, text, threshold=thr) == want
    assert set(eng.timings) == {"tsd"}


def test_engines_need_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in (CaptionEngine, SEDEngine, TSDEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine()
