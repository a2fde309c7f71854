"""Port GenerSpeech's modules (``audiogpt_tpu_torch/models/tts/
generspeech.py``) against the JAX package on shared parameters and
replayed draws, through one compiled JAX program: the local style branch
(conv stack and VQ) and the global style encoder on an odd and an even
reference length, a prosody aligner, the Glow post-flow (forward with its
NLL, reverse, and the round trip), and the VQ's EMA update of its
codebook and statistics over two training calls (within 1e-6 of each
array's largest). The whole model and
``StyleTransferEngine`` are in ``test_torch_style_transfer.py``, which
shares this file's configs and parameters.

Every layer that JAX zero-initialises (``WNCoupling.end``, the actnorms)
gets random values on both sides (``_random_params``), or the flow would
ignore its conditioning; the 1×1 convolutions get random orthogonal
matrices, as JAX initialises them (a random matrix's inverse would
amplify the frameworks' difference by its condition number). The duration
head's weights are scaled by 1e-3 with a bias of 3 frames a phone, and the
pitch head's f0 output the same around one coarse bin's middle, so no
rounded duration or pitch bin sits near its edge; each VQ choice is
checked to lie far from a tie. Tolerance: module outputs within 1e-4
absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.tts import fastspeech2 as jfs
from audiogpt_tpu.models.tts import generspeech as jgs
from audiogpt_tpu_torch.models.tts import FastSpeech2Config
from audiogpt_tpu_torch.models.tts import generspeech as pgs
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_svs import ATOL, init_params, to_torch

torch.set_num_threads(2)

MELS = 20
FS2 = dict(vocab_size=90, hidden_size=16, enc_layers=1, dec_layers=1,
           num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
           n_mels=MELS, dur_predictor_layers=1, predictor_layers=1,
           predictor_hidden=8, max_frames=64)
GS = dict(n_vq=8, emb_dim=16, glow_hidden=16, glow_steps=2,
          glow_wn_layers=2)
TOKENS, REF_FRAMES = 32, 64         # the engine's buckets
#: exp(d) − 1 = 3.0 frames a phone, mid-way between rounding edges
DUR_FRAMES = 3.0


def configs():
    return (jgs.GenerSpeechConfig(fs2=jfs.FastSpeech2Config(**FS2), **GS),
            pgs.GenerSpeechConfig(fs2=FastSpeech2Config(**FS2), **GS))


def gs_params(jcfg, seed: int) -> dict:
    p = init_params(jgs.GenerSpeech(jcfg), jnp.ones((1, TOKENS), jnp.int32),
                    jnp.zeros((1, REF_FRAMES, MELS)), seed=seed)
    rng = np.random.RandomState(seed)
    flow = p["params"]["post_flow"]
    for step in flow.values():
        c = step["inv1x1_w"].shape[0]
        step["inv1x1_w"][:] = np.linalg.qr(rng.randn(c, c))[0]
    assert np.abs(flow["step0"]["wn"]["end"]["kernel"]).max() > 0
    assert np.abs(flow["step0"]["actnorm_logs"]).max() > 0
    dur = p["params"]["dur_predictor"]["out"]
    dur["kernel"] *= 1e-3
    dur["bias"][:] = np.log(DUR_FRAMES + 1.0)
    pitch = p["params"]["pitch_inpainter"]["out"]
    pitch["kernel"][:, 0] *= 1e-3
    # mid coarse bin 60: (f0 − 200) / 60 in the normalised domain
    mel = 59 * (jfs.F0_MEL_MAX - jfs.F0_MEL_MIN) / (jfs.F0_BIN - 2) \
        + jfs.F0_MEL_MIN
    pitch["bias"][0] = (700.0 * np.expm1(mel / 1127.0) - 200.0) / 60.0
    return p


@pytest.fixture(scope="module")
def engines():
    """(JAX module, port module, params) on shared parameters."""
    jcfg, pcfg = configs()
    params = gs_params(jcfg, seed=20)
    model = pgs.GenerSpeech(pcfg).eval()
    load_jax_params(model, params)
    return jgs.GenerSpeech(jcfg), model, params


def ref_mel(frames: int, seed: int = 0) -> np.ndarray:
    """A reference log-mel [1, REF_FRAMES, MELS] whose frames past
    ``frames`` are padding (zero)."""
    mel = np.zeros((1, REF_FRAMES, MELS), np.float32)
    mel[0, :frames] = np.random.RandomState(seed).randn(frames, MELS) - 3.0
    return mel


def vq_gap(h: np.ndarray, codes: np.ndarray) -> float:
    """The smallest gap between a row's nearest and second-nearest code
    (squared distance)."""
    d = ((h[:, None, :] - codes[None]) ** 2).sum(-1)
    d.sort(-1)
    return float((d[:, 1] - d[:, 0]).min())


#: the module tests' inputs: two references (64 valid frames, which halve
#: evenly four times, so lax's SAME pads (0, 1); and 47), an aligner's text
#: and style, and a post-flow mel with an odd valid length
REFS = np.concatenate([ref_mel(REF_FRAMES, seed=1), ref_mel(47, seed=2)])
_rng = np.random.RandomState(3)
ALIGN = (_rng.randn(2, 24, 16).astype(np.float32),
         _rng.randn(2, 40, 16).astype(np.float32),
         np.ones((2, 24), np.float32),
         (np.arange(40) < np.array([[40], [29]])).astype(np.float32))
GLOW = (_rng.randn(1, 30, MELS).astype(np.float32),
        _rng.randn(1, 30, MELS + 16).astype(np.float32),
        (np.arange(30) < 23).astype(np.float32)[None])
GLOW_KEY = jax.random.PRNGKey(6)


@pytest.fixture(scope="module")
def jax_parts(engines):
    """The JAX modules on those inputs, one compiled program: the
    utterance-level style branch and the global style encoder, a prosody
    aligner, the post-flow forward and reverse."""
    jmodel, _, params = engines

    def parts(s, refs, align, glow):
        nonpad = (jnp.abs(refs).sum(-1) > 0).astype(jnp.float32)
        return {"quant": s.style_utter(refs, nonpad)[0],
                "global": s.global_style(refs, nonpad),
                "aligned": s.align_ph(*align)[0],
                "glow": s.post_flow.forward(*glow),
                "reverse": s.post_flow.reverse(*glow[1:], GLOW_KEY)}

    return jax.jit(lambda p, *a: jmodel.apply(p, *a, method=parts))(
        params, REFS, ALIGN, GLOW)


def test_style_encoders_match_jax(engines, jax_parts):
    """The utterance-level style branch (conv stack, VQ) and the global
    style encoder on the two references; the 20 mel bins reach an odd 5."""
    _, model, _ = engines
    nonpad = to_torch((np.abs(REFS).sum(-1) > 0).astype(np.float32))
    with torch.no_grad():
        h = model.style_utter.encoder(to_torch(REFS), nonpad)
        quant = model.style_utter(to_torch(REFS), nonpad)
        spk, emo = model.global_style(to_torch(REFS))
    # every row's nearest code is far from a tie (the distances' f32 error
    # is ~1e-6): the VQ choices agree
    codes = model.style_utter.vq.embedding.numpy()
    assert vq_gap(h.numpy().reshape(-1, h.shape[-1]), codes) > 1e-3
    np.testing.assert_allclose(quant.numpy(), jax_parts["quant"], atol=ATOL,
                               rtol=0)
    for got, ref in zip((spk, emo), jax_parts["global"]):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert len(np.unique(quant.numpy()[1, :47], axis=0)) > 1


def test_prosody_aligner_matches_jax(engines, jax_parts):
    _, model, _ = engines
    text, style, _, style_nonpad = ALIGN
    with torch.no_grad():
        got = model.align_ph(to_torch(text), to_torch(style),
                                 to_torch(style_nonpad))
    np.testing.assert_allclose(got.numpy(), jax_parts["aligned"], atol=ATOL,
                               rtol=0)


def test_glow_matches_jax(engines, jax_parts):
    """Forward (z and the NLL) on a mel with an odd valid length, reverse
    from a replayed z at temperature 0.8, and the round trip."""
    _, model, _ = engines
    glow = model.post_flow
    mel, cond, mask = (to_torch(a) for a in GLOW)
    draws = to_torch(jax.random.normal(GLOW_KEY, (1, 15, 2 * MELS)))
    with torch.no_grad():
        z, nll = glow(mel, cond, mask)
        rev = glow.reverse(cond, mask, draws)
        back = glow.reverse(cond, mask, z / 0.8)
    ref_z, ref_nll = jax_parts["glow"]
    np.testing.assert_allclose(z.numpy(), ref_z, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(nll), float(ref_nll), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(rev.numpy(), jax_parts["reverse"], atol=ATOL,
                               rtol=0)
    assert np.abs(np.asarray(jax_parts["reverse"])).max() > 0.1
    # the pairs of frames whose mask is 1 come back
    np.testing.assert_allclose(back.numpy()[0, :22], GLOW[0][0, :22],
                               atol=ATOL, rtol=0)
    assert (back.numpy()[0, 22:] == 0).all()


def test_vq_ema_update_matches_jax():
    """Two training calls of the EMA quantizer (JAX: ``train=True`` with
    the mutable ``vq_stats``) from random statistics: each call's code
    vectors and straight-through output, then the codebook, ``ema_weight`` and
    ``ema_count``, equal JAX's; an inference call leaves them as they
    are. Each input's nearest code is checked to win by a margin."""
    rng = np.random.default_rng(21)
    jvq = jgs.VQEmbeddingEMA(n_codes=8, dim=16)
    stats = {"embedding": rng.normal(size=(8, 16)),
             "ema_weight": rng.normal(size=(8, 16)),
             "ema_count": rng.uniform(0.5, 2.0, 8)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    xs = [rng.normal(size=(2, 12, 16)).astype(np.float32) for _ in range(2)]
    step = jax.jit(lambda v, x: jvq.apply(v, x, train=True,
                                          mutable=["vq_stats"]))
    vq = pgs.VQEmbeddingEMA(n_codes=8, dim=16)
    for name, arr in stats.items():
        getattr(vq, name).copy_(torch.from_numpy(arr))
    variables = {"vq_stats": stats}
    for x in xs:
        d = ((x.reshape(-1, 1, 16) - variables["vq_stats"]["embedding"]
              ) ** 2).sum(-1)
        gap = np.sort(d, axis=1)
        assert (gap[:, 1] - gap[:, 0]).min() > 1e-3
        (q_st, _, quant), variables = step(variables, x)
        variables = jax.tree.map(np.asarray, variables)
        got_st, got_q = vq(torch.from_numpy(x), train=True)
        for got, want in ((got_q, quant), (got_st, q_st)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    for name, want in variables["vq_stats"].items():
        got = getattr(vq, name).numpy()
        assert np.abs(got - stats[name]).max() > 1e-4, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    before = vq.embedding.clone()
    vq(torch.from_numpy(xs[0]))
    assert torch.equal(vq.embedding, before)
