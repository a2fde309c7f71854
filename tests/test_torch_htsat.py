"""Port HTSAT, CLAP's Swin audio tower (``audiogpt_tpu_torch/models/
textenc/htsat.py``), and the scorer's ``htsat`` tower against the JAX
package on shared parameters: ``reshape_wav2img`` (a stretch, a crop, a
one-frame repeat), ``WindowAttention`` with and without the shift mask,
a shifted ``SwinBlock`` and one that takes the clamp rule (grid no larger
than the window), ``PatchMerging``, ``HTSATAudioEncoder`` with
``return_dict`` and ``CLAPScorer(audio_tower="htsat")`` by ``score`` and
``select_best``; and the scorer's config checks.

Tolerances: module outputs within 1e-4 absolute (f32 through a few
layers on shared weights); scorer similarities within 1e-5, as in
``test_torch_clap_scorer.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.dsp.mel import MelSpec as JaxMelSpec
from audiogpt_tpu.models.textenc import BertConfig as JaxBertConfig
from audiogpt_tpu.models.textenc import CLAPTextConfig as JaxCLAPConfig
from audiogpt_tpu.models.textenc import CLAPTextEncoder as JaxCLAPText
from audiogpt_tpu.models.textenc import htsat as jh
from audiogpt_tpu.models.textenc.clap import CLAPScorer as JaxCLAPScorer
from audiogpt_tpu_torch.dsp.mel import MelSpec
from audiogpt_tpu_torch.models.textenc import (BertConfig, CLAPScorer,
                                               CLAPTextConfig)
from audiogpt_tpu_torch.models.textenc import htsat as ph
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_clap_scorer import BERT, _wavs
from test_torch_cnn14 import random_variables
from test_torch_svs import ATOL, init_params, to_torch

torch.set_num_threads(2)

MEL = dict(sr=32000, n_fft=1024, hop=320, win_length=1024, n_mels=16,
           fmin=50.0, fmax=14000.0, power=2.0, pad_mode="reflect",
           log="db10", amin=1e-10)
#: a 16 × 16 patch grid: stage 0 shifts its windows, stage 1 (8 × 8)
#: takes the clamp rule
TINY = dict(spec_size=64, patch=4, window=8, embed_dim=32, depths=(2, 2),
            num_heads=(2, 4), num_classes=10, d_proj=24)


def configs(**kw):
    return (jh.HTSATConfig(mel=JaxMelSpec(**MEL), **{**TINY, **kw}),
            ph.HTSATConfig(mel=MelSpec(**MEL), **{**TINY, **kw}))


def audio_params(jcfg, seed: int) -> dict:
    """The JAX tower's params, every leaf random; ``bn0_var`` positive."""
    p = init_params(jh.HTSATAudioEncoder(jcfg), jnp.zeros((1, 32000)),
                    seed=seed)
    p["params"]["bn0_var"] = 1.0 + np.abs(p["params"]["bn0_var"])
    return p


def apply_both(jmod, pmod, x, *args, seed=0, **kw):
    """``jmod`` (jitted) and ``pmod`` on the same params and input."""
    params = init_params(jmod, jnp.asarray(x), *args, seed=seed, **kw)
    ref = jax.jit(lambda p, x: jmod.apply(p, x, *args, **kw))(params, x)
    load_jax_params(pmod, params)
    with torch.no_grad():
        got = pmod.eval()(to_torch(x), *(to_torch(a) if a is not None
                                         else None for a in args))
    return ref, got


@pytest.mark.parametrize("frames", [101, 300, 1],
                         ids=["stretch", "crop", "one-frame"])
def test_reshape_wav2img_matches_jax(frames):
    mel = np.random.RandomState(frames).randn(2, frames, 16).astype(
        np.float32)
    ref = jax.jit(jh.reshape_wav2img, static_argnums=(1, 2))(
        jnp.asarray(mel), 64, 4)
    got = ph.reshape_wav2img(to_torch(mel), 64, 4)
    assert got.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_matches_jax(shifted):
    x = np.random.RandomState(1).randn(8, 64, 32).astype(np.float32)
    mask = jh._shift_attn_mask(16, 16, 8, 4) if shifted else None
    ref, got = apply_both(jh.WindowAttention(32, 2, 8),
                          ph.WindowAttention(32, 2, 8), x, mask)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("grid", [16, 8], ids=["shifted", "clamped"])
def test_swin_block_matches_jax(grid):
    x = np.random.RandomState(grid).randn(2, grid, grid, 32).astype(
        np.float32)
    block = ph.SwinBlock(32, 2, 8, 4, 4, grid)
    assert (block.window, block.shift) == ((8, 4) if grid > 8 else (8, 0))
    ref, got = apply_both(jh.SwinBlock(32, 2, 8, 4, 4), block, x)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_patch_merging_matches_jax():
    x = np.random.RandomState(2).randn(2, 8, 8, 32).astype(np.float32)
    ref, got = apply_both(jh.PatchMerging(64), ph.PatchMerging(32, 64), x)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def encoder_ref():
    """The JAX tower with its projection, on random params, with
    ``return_dict``: one compiled program for both cases below."""
    jcfg, _ = configs()
    params = audio_params(jcfg, seed=3)
    wav = _wavs(2, 32000, seed=4)
    ref = jax.jit(lambda p, w: jh.HTSATAudioEncoder(jcfg).apply(
        p, w, return_dict=True))(params, wav)
    return params, wav, ref


@pytest.mark.parametrize("project", [True, False],
                         ids=["projected", "swin-embedding"])
def test_encoder_matches_jax(encoder_ref, project):
    """With the CLAP projection (the scorer's) and without it (the bare
    Swin embedding; JAX's tree less ``projection``, its outputs less
    ``projected``)."""
    params, wav, ref = encoder_ref
    if not project:
        params = {"params": {k: v for k, v in params["params"].items()
                             if k != "projection"}}
        ref = {k: v for k, v in ref.items() if k != "projected"}
    model = ph.HTSATAudioEncoder(configs(project=project)[1]).eval()
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(to_torch(wav), return_dict=True)
        emb = model(to_torch(wav))
    assert set(got) == set(ref)
    # T' = freq_ratio · the last grid's width (4 · 8), repeated 8 · patch
    assert got["framewise"].shape == (2, 4 * 8 * 32, 10)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=ATOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(
        emb.numpy(), ref["projected" if project else "embedding"],
        atol=ATOL, rtol=0)


def make_htsat_scorers(d_proj=24, seed=5):
    """The JAX and port scorers with the HTSAT tower on shared params; the
    tower's config carries another ``d_proj``, which the scorer
    replaces with the text tower's."""
    jcfg, pcfg = configs(d_proj=7)
    text_cfg = dict(d_proj=d_proj, max_length=16)
    jtext = JaxCLAPConfig(bert=JaxBertConfig(**BERT), **text_cfg)
    tp = random_variables(jax.eval_shape(
        JaxCLAPText(jtext).init, jax.random.PRNGKey(0),
        np.zeros((1, 4), np.int32)), seed)
    ap = audio_params(configs(d_proj=d_proj)[0], seed + 1)
    jsc = JaxCLAPScorer(jtext, text_params=tp, audio_params=ap,
                        sample_rate=16000, audio_tower="htsat",
                        audio_cfg=jcfg)
    sc = CLAPScorer(CLAPTextConfig(bert=BertConfig(**BERT), **text_cfg),
                    text_params=tp, audio_params=ap, sample_rate=16000,
                    audio_tower="htsat", audio_cfg=pcfg, device="cpu")
    return jsc, sc


def test_htsat_scorer_matches_jax():
    jsc, sc = make_htsat_scorers()
    assert sc.audio.cfg.d_proj == 24
    wavs = _wavs(3, 40000, seed=6)
    for text in ("a dog barks in the rain", "thunder"):
        ref = jsc.score(text, wavs)
        got = sc.score(text, wavs)
        assert got.shape == (3,) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        assert np.ptp(ref) > 1e-3
        assert sc.select_best(text, wavs) == jsc.select_best(text, wavs)


def test_scorer_refuses_an_htsat_config_under_pann():
    """(The reverse, a ``Cnn14Config`` under ``htsat``, is in
    ``test_torch_clap_scorer.py``.)"""
    with pytest.raises(TypeError):
        CLAPScorer(audio_tower="pann", audio_cfg=configs()[1], device="cpu")
