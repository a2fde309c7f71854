"""Port PortaSpeech / SyntaSpeech (``audiogpt_tpu_torch/models/tts/
portaspeech.py``, ``ops/rel_attention.py``, ``text/syntax.py`` and
``engines/tts.py`` ``PortaSpeechTTSEngine``) against the JAX package on
shared parameters and replayed draws: the word graphs exactly, the
relative-window encoder, the GGNN layer, the prior flow both ways (and its
round trip), the FVAE decoder, the model at inference with the graph on
and off, the engine, ``synthesize_stream``'s phone and word caps, JAX's
tree for each of the config's four switches, and the training and
inference branches with FFT encoders, no text postnet and no prior flow.

Every leaf of the JAX trees is random (``test_torch_bigvgan.
_random_params``), the layers JAX zero-initialises among them
(``ConvReluNorm.proj``, ``CondCoupling.post``, ``prior_graph_proj``), or
a comparison would show nothing; the tests check that they are not zero.
The duration head's weights are scaled by 1e-3 with a bias of 1.7 frames
a phone, so every word's rounded duration (1.7, 3.4, 5.1, … frames) sits
at least 0.1 frame from a rounding edge.

Tolerances: module outputs within 1e-4 absolute, the sampled mel and the
wav within 5e-4 (through the prior flow and the decoder), the training
branch's outputs within 1e-5 of each array's largest."""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu import text as jtext
from audiogpt_tpu.engines import tts as jtts
from audiogpt_tpu.engines.base import Bucketer as JaxBucketer
from audiogpt_tpu.engines.vocoder import VocoderEngine as JaxVocoderEngine
from audiogpt_tpu.models.tts import portaspeech as jps
from audiogpt_tpu.models.vocoder import hifigan as jh
from audiogpt_tpu.ops import rel_attention as jrel
from audiogpt_tpu.text import syntax as jsyn
from audiogpt_tpu_torch import text as ptext
from audiogpt_tpu_torch.engines import tts
from audiogpt_tpu_torch.engines.base import Bucketer
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.tts import portaspeech as pps
from audiogpt_tpu_torch.models.vocoder import hifigan as ph
from audiogpt_tpu_torch.ops import rel_attention as prel
from audiogpt_tpu_torch.text import syntax as psyn
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_svs import ATOL, SAMPLE_ATOL, init_params, to_torch

torch.set_num_threads(2)

MELS = 16
PS = dict(ph_vocab_size=90, word_vocab_size=30, hidden_size=32,
          enc_layers=1, word_enc_layers=1, num_heads=2, n_mels=MELS,
          dur_predictor_layers=1, fvae_hidden=32, fvae_dec_layers=1,
          prior_flow_hidden=16, prior_flow_blocks=2, graph_steps=2,
          max_frames=64, latent_size=8)
#: frames a phone from the duration head (softplus of its bias)
PHONE_FRAMES = 1.7
#: the training branch's outputs, relative to each array's largest
FWD_RTOL = 1e-5


def configs(**kw):
    return (jps.PortaSpeechConfig(**{**PS, **kw}),
            pps.PortaSpeechConfig(**{**PS, **kw}))


def fill_durations(params: dict) -> None:
    out = params["params"]["dur_predictor"]["out"]
    out["kernel"] *= 1e-3
    out["bias"][:] = np.log(np.expm1(PHONE_FRAMES))


# -- syntax graphs: exactly the JAX package's --------------------------------

WORD_LISTS = {
    "clauses": ["the", "big", "cat", ",", "sat", "down", "."],
    "leading-punct": [",", "hello", "there", "!", "you"],
    "only-punct": [".", ","],
    "no-punct": ["a", "b", "c", "d"],
    "cjk": ["你", "好", "，", "世界", "。"],
    "bar": ["one", "|", "two", "three", "?"],
    "empty": [],
}


@pytest.mark.parametrize("words", WORD_LISTS.values(), ids=WORD_LISTS)
def test_word_graphs_equal_jax(words):
    assert psyn._heuristic_heads(words) == jsyn._heuristic_heads(words)
    np.testing.assert_array_equal(psyn.build_word_graph(words, 9),
                                  jsyn.build_word_graph(words, 9))
    heads = [0] + [1] * (len(words) - 1) if words else []
    np.testing.assert_array_equal(
        psyn.batch_word_graphs([words, ["x"]], 9, [heads, None]),
        jsyn.batch_word_graphs([words, ["x"]], 9, [heads, None]))


# -- word-level helpers ------------------------------------------------------

HELPERS = ("word_onehot", "group_hidden_by_words", "expand_word_states",
           "in_word_position", "clip_mel2word_to_multiple",
           "mel2word_to_dur")


@pytest.fixture(scope="module")
def word_helpers():
    """Every helper of both packages on a phone → word map with padding
    (word 0) whose length is not a multiple of 4; the JAX side in one
    compiled program."""
    x2word = np.array([[1, 1, 2, 3, 3, 3, 0, 0], [1, 2, 2, 2, 2, 4, 4, 0]],
                      np.int32)
    h = np.random.RandomState(12).randn(2, 8, 3).astype(np.float32)

    def run(pkg, x, h):
        return {"word_onehot": pkg.word_onehot(x, 5),
                "group_hidden_by_words": pkg.group_hidden_by_words(h, x, 5),
                "expand_word_states": pkg.expand_word_states(h[:, :5], x),
                "in_word_position": pkg.in_word_position(x, 5),
                "clip_mel2word_to_multiple":
                    pkg.clip_mel2word_to_multiple(x, 4),
                "mel2word_to_dur": pkg.mel2word_to_dur(x, 5)}

    ref = jax.jit(lambda x, h: run(jps, x, h))(x2word, h)
    return ref, run(pps, to_torch(x2word).long(), to_torch(h))


@pytest.mark.parametrize("helper", HELPERS)
def test_word_helpers_match_jax(word_helpers, helper):
    ref, got = word_helpers
    np.testing.assert_allclose(got[helper].numpy(), ref[helper], atol=ATOL,
                               rtol=0)


# -- modules -----------------------------------------------------------------

def nonpad(b: int, t: int, lens) -> np.ndarray:
    return (np.arange(t)[None] < np.asarray(lens)[:, None]).astype(
        np.float32).reshape(b, t)


def test_rel_transformer_encoder_matches_jax():
    x = np.random.RandomState(1).randn(2, 12, 16).astype(np.float32)
    m = nonpad(2, 12, [12, 7])
    jmod = jrel.RelTransformerEncoder(0, 16, 32, 2, 1, 3, 2)
    params = init_params(jmod, x, m, seed=2)
    assert np.abs(params["params"]["pre"]["proj"]["kernel"]).min() > 0
    ref = jax.jit(jmod.apply)(params, x, m)
    model = prel.RelTransformerEncoder(16, 32, 2, 1, 3, 2).eval()
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(to_torch(x), to_torch(m))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_gated_graph_conv_matches_jax():
    rng = np.random.RandomState(3)
    h = rng.randn(2, 6, 16).astype(np.float32)
    adj = jsyn.batch_word_graphs([["a", "b", ",", "c", "d", "."],
                                  ["x", "y", "z"]], 6)
    mask = nonpad(2, 6, [6, 3])[..., None]
    jmod = jps.GatedGraphConv(16, steps=3)
    params = init_params(jmod, h, adj, mask, seed=4)
    ref = jax.jit(jmod.apply)(params, h, adj, mask)
    model = pps.GatedGraphConv(16, steps=3).eval()
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(to_torch(h), to_torch(adj), to_torch(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def flow_and_decoder():
    """The prior flow and the FVAE decoder on shared params and inputs."""
    jcfg, pcfg = configs()
    rng = np.random.RandomState(5)
    z = rng.randn(2, 16, 8).astype(np.float32)
    cond = rng.randn(2, 16, 32).astype(np.float32)
    lat = nonpad(2, 16, [16, 11])[..., None]
    frames = nonpad(2, 64, [64, 44])[..., None]
    flow = init_params(jps.PriorFlow(jcfg), z, cond, lat, seed=6)
    assert np.abs(flow["params"]["f0"]["post"]["kernel"]).min() > 0
    dec = init_params(jps.FVAEDecoder(jcfg), z, cond, lat, frames, seed=7)
    jflow = jax.jit(jps.PriorFlow(jcfg).apply, static_argnums=4)
    ref = {"forward": jflow(flow, z, cond, lat, False),
           "reverse": jflow(flow, z, cond, lat, True),
           "decoder": jax.jit(jps.FVAEDecoder(jcfg).apply)(dec, z, cond,
                                                            lat, frames)}
    pflow, pdec = pps.PriorFlow(pcfg).eval(), pps.FVAEDecoder(pcfg).eval()
    load_jax_params(pflow, flow)
    load_jax_params(pdec, dec)
    args = [to_torch(a) for a in (z, cond, lat)]
    with torch.no_grad():
        got = {"forward": pflow(*args), "reverse": pflow(*args, reverse=True),
               "decoder": pdec(*args, to_torch(frames))}
        got["round_trip"] = pflow(got["forward"], *args[1:], reverse=True)
    return ref, got, z * lat


@pytest.mark.parametrize("part", ["forward", "reverse", "decoder"])
def test_flow_and_decoder_match_jax(flow_and_decoder, part):
    ref, got, _ = flow_and_decoder
    np.testing.assert_allclose(got[part].numpy(), ref[part], atol=ATOL,
                               rtol=0)


def test_prior_flow_round_trip(flow_and_decoder):
    _, got, z = flow_and_decoder
    assert float((got["forward"] - torch.from_numpy(z)).abs().max()) > 1e-2
    np.testing.assert_allclose(got["round_trip"].numpy(), z, atol=ATOL,
                               rtol=0)


# -- the model and the engine ------------------------------------------------

HIFI = dict(in_channels=MELS, upsample_initial_channel=16,
            upsample_rates=(16,), upsample_kernel_sizes=(32,),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
TEXT = "Hello world, how are you?"
PHONES, WORDS = 32, 16                   # the engines' one bucket each


@pytest.mark.parametrize("switch", [
    dict(encoder_type="fft"), dict(text_encoder_postnet=False),
    dict(use_prior_flow=False), dict(num_spk=4)], ids=lambda d: next(iter(d)))
def test_switches_away_from_the_app_are_refused(switch):
    """The JAX config's four switches away from the app's values are no
    longer refused: the model builds what JAX builds (FFT blocks, the
    phone-to-word encoder's without positions; ``dec_query_proj`` in place
    of ``text_postnet``; no ``prior_flow``; ``spk_embed`` of ``num_spk +
    1`` rows), so JAX's training tree loads strictly. (flax makes the
    speaker table only when the init gets a speaker: this one does.)"""
    jcfg, pcfg = configs(**switch)
    toks = jnp.ones((1, 8), jnp.int32)
    params = init_params(jps.PortaSpeech(jcfg), toks, toks[:, :4], toks,
                         mel2word=toks, tgt_mels=jnp.zeros((1, 8, MELS)),
                         spk_id=toks[:, 0], rng=jax.random.PRNGKey(0),
                         seed=13)
    tree = params["params"]
    assert ("prior_flow" in tree) == pcfg.use_prior_flow
    assert ("text_postnet" in tree) == pcfg.text_encoder_postnet
    if pcfg.encoder_type == "fft":
        assert "pos_alpha" not in tree["ph2word_encoder"]
        assert "pos_alpha" in tree["encoder"]
    if pcfg.num_spk:
        assert tree["spk_embed"]["embedding"].shape == (5, PS["hidden_size"])
    load_jax_params(pps.PortaSpeech(pcfg, posterior=True), params)


def test_fft_no_postnet_no_prior_flow_matches_jax():
    """One config with the three other switches flipped together, against
    one compiled JAX program: the training forward (ε replayed) and the
    inference branch on the same ground-truth ``mel2word`` (its draw
    replayed): the mel, the KL, the durations, the attention, the
    unflowed ``z_p`` (= ``z_q``) and the decoder input, each within
    ``FWD_RTOL`` of its largest value (the random posterior's log-scales
    put the training latent at ≈ 1e5), and the inference mel within
    ``SAMPLE_ATOL``."""
    kw = dict(encoder_type="fft", text_encoder_postnet=False,
              use_prior_flow=False)
    jcfg, pcfg = configs(**kw)
    rng = np.random.default_rng(14)
    txt = np.zeros((2, 12), np.int32)
    txt[0], txt[1, :7] = rng.integers(3, 90, 12), rng.integers(3, 90, 7)
    p2w = np.zeros((2, 12), np.int32)
    p2w[0], p2w[1, :7] = np.arange(12) // 2 + 1, np.arange(7) // 2 + 1
    words = np.zeros((2, 8), np.int32)
    words[0, :6], words[1, :4] = rng.integers(1, 30, 6), rng.integers(1, 30,
                                                                      4)
    frames = PS["max_frames"]          # the inference branch's canvas
    m2w = np.zeros((2, frames), np.int32)
    m2w[0] = np.arange(frames) * 6 // frames + 1
    m2w[1, :40] = np.arange(40) // 10 + 1
    mels = (rng.normal(size=(2, frames, MELS)) * (m2w > 0)[..., None]
            ).astype(np.float32)
    model = jps.PortaSpeech(jcfg)
    params = init_params(model, txt, words, p2w, mel2word=m2w,
                         tgt_mels=mels, rng=jax.random.PRNGKey(0), seed=15)
    key = jax.random.PRNGKey(16)

    def both(p):
        train = model.apply(p, txt, words, p2w, mel2word=m2w,
                            tgt_mels=mels, rng=key)
        infer = model.apply(p, txt, words, p2w, mel2word=m2w, infer=True,
                            rng=key, noise_scale=0.8)
        eps = jax.random.normal(key, train["m_q"].shape)
        noise = jax.random.normal(key, (2, PS["max_frames"] // 4,
                                        PS["latent_size"]))
        return train, infer["mel_out"], eps, noise

    train, infer, eps, noise = jax.tree.map(np.asarray,
                                            jax.jit(both)(params))
    net = pps.PortaSpeech(pcfg, posterior=True).eval()
    load_jax_params(net, params)
    args = [to_torch(a).long() for a in (txt, words, p2w, m2w)]
    with torch.no_grad():
        got = net.train_forward(*args, to_torch(mels),
                                draws=to_torch(eps))
        enc = net.encode(*args[:3], mel2word=args[3])
        z = net.prior(enc["x"], args[3], None, to_torch(noise), 0.8)
        mel = net.decode(z, enc["x"], args[3])
    lat = to_torch(m2w[:, ::4] > 0).float()[..., None]
    z_q = (got["m_q"] + got["logs_q"].exp() * to_torch(eps)) * lat
    np.testing.assert_array_equal(got["z_p"].numpy(), z_q.numpy())
    for k in ("mel_out", "kl", "dur", "attn", "z_p", "decoder_inp"):
        np.testing.assert_allclose(got[k].numpy(), train[k], rtol=0,
                                   atol=FWD_RTOL * np.abs(train[k]).max(),
                                   err_msg=k)
    np.testing.assert_allclose(mel.numpy(), infer, atol=SAMPLE_ATOL, rtol=0)


@pytest.fixture(scope="module", params=[False, True],
                ids=["portaspeech", "syntaspeech"])
def engines(request):
    """(JAX engine, port engine, params, JAX program) with the graph off
    and on: shared PortaSpeech and HiFi-GAN parameters, one phone and one
    word bucket. The JAX program is the whole model's output at the
    buckets' shapes; the JAX engine runs it too (its ``_fn`` is the
    program's ``mel_out``), so the model and the engine tests share one
    compile."""
    use_graph = request.param
    vocab = len(jtext.default_arpabet_vocab()) + 3
    jcfg, pcfg = configs(use_graph=use_graph, ph_vocab_size=vocab,
                         word_vocab_size=4)
    tokens = jnp.ones((1, 8), jnp.int32)
    params = init_params(jps.PortaSpeech(jcfg), tokens, tokens, tokens,
                         graph_adj=jnp.zeros((1, 6, 8, 8)) if use_graph
                         else None, infer=True, rng=jax.random.PRNGKey(0),
                         seed=11)
    fill_durations(params)
    tree = params["params"]
    assert "fvae_enc" not in tree
    assert ("prior_graph_proj" in tree) == use_graph
    if use_graph:
        assert np.abs(tree["prior_graph_proj"]["kernel"]).min() > 0
    vparams = init_params(jh.HifiGANGenerator(jh.HifiGANConfig(**HIFI)),
                          jnp.zeros((1, 16, MELS)), seed=12)
    kw = dict(cfg=jcfg, params=params, token_buckets=(PHONES,),
              word_buckets=(WORDS,), rng_seed=3)
    jeng = jtts.PortaSpeechTTSEngine(
        vocoder=JaxVocoderEngine("hifigan", cfg=jh.HifiGANConfig(**HIFI),
                                 params=vparams, buckets=(64,)), **kw)
    eng = tts.PortaSpeechTTSEngine(
        vocoder=VocoderEngine("hifigan", cfg=ph.HifiGANConfig(**HIFI),
                              params=vparams, buckets=(64,), device="cpu"),
        device="cpu", **{**kw, "cfg": pcfg})
    program = jax.jit(lambda p, toks, words, p2w, adj, rng: jeng.model.apply(
        p, toks, words, p2w, graph_adj=adj, infer=True, rng=rng,
        noise_scale=jeng.noise_scale))
    jeng._fn = lambda *a: program(*a)["mel_out"]
    return jeng, eng, params, program


def test_portaspeech_matches_jax(engines):
    """The whole model on padded random ids (14 of the phones, 7 of the
    words), the prior's draw replayed."""
    jeng, eng, params, program = engines
    rng = np.random.default_rng(8)
    txt = np.zeros((1, PHONES), np.int32)
    txt[0, :14] = rng.integers(3, jeng.cfg.ph_vocab_size, 14)
    p2w = np.zeros((1, PHONES), np.int32)
    p2w[0, :14] = np.arange(14) // 2 + 1
    words = np.zeros((1, WORDS), np.int32)
    words[0, :7] = rng.integers(1, 4, 7)
    adj = jsyn.build_word_graph(["the", "cat", ",", "sat", "down", ".",
                                 "ok"], WORDS)[None]
    if not jeng.cfg.use_graph:
        adj = np.zeros_like(adj)
    key = jax.random.PRNGKey(10)
    ref = program(params, txt, words, p2w, adj, key)
    noise = jax.random.normal(key, (1, PS["max_frames"] // 4,
                                    PS["latent_size"]))
    with torch.no_grad():
        got = eng.model(*(to_torch(a).long() for a in (txt, words, p2w)),
                        graph_adj=to_torch(adj) if jeng.cfg.use_graph
                        else None, draws=to_torch(noise), noise_scale=0.8)
    np.testing.assert_array_equal(got["mel2word"].numpy(), ref["mel2word"])
    # 7 words of 2 · 1.7 frames: 3 frames each, cut to a multiple of 4
    assert int((got["mel2word"] > 0).sum()) == 20
    for key in ("dur", "attn", "decoder_inp"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=ATOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(got["mel_out"].numpy(), ref["mel_out"],
                               atol=SAMPLE_ATOL, rtol=0)


def test_engine_matches_jax(engines):
    """``text_to_mel`` with the JAX engine's next draw (its call counter
    folded into its key) replayed, and the vocoder's wav of that mel."""
    jeng, eng, _, _ = engines
    count = next(jeng._call_counter)
    jeng._call_counter = itertools.count(count)
    noise = jax.random.normal(jax.random.fold_in(jeng._base_rng, count),
                              (1, PS["max_frames"] // 4, PS["latent_size"]))
    ref = jeng.text_to_mel(TEXT)
    got = eng.text_to_mel(TEXT, draws=to_torch(noise))
    inputs = eng.inputs(TEXT)
    assert inputs["word_tokens"].shape == (1, WORDS)
    assert int((inputs["word_tokens"] > 0).sum()) == 9   # 7 + BOS/EOS
    assert ("graph_adj" in inputs) == eng.cfg.use_graph
    assert got.shape == ref.shape and got.shape[0] >= 40
    np.testing.assert_allclose(got, ref, atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(eng.vocoder(got), jeng.vocoder(ref),
                               atol=SAMPLE_ATOL, rtol=0)


@pytest.mark.parametrize("word_buckets", [(8,), None],
                         ids=["word-cap", "fs2-no-word-cap"])
def test_synthesize_stream_caps_match_jax(word_buckets):
    """The chunks ``synthesize_stream`` makes, for an engine with a word
    bucket ladder (8 words: 6 of the text's and ``<BOS>`` / ``<EOS>``) and
    for one with only ``bucketer`` and no ``_fused_ok`` (the FS2 surface
    without a fused pass), equal the JAX function's on the same stubs."""
    text = ("one two three four five six seven eight nine ten, "
            "eleven twelve. thirteen")

    def stub(pkg, make_bucketer, chunks):
        eng = types.SimpleNamespace(
            frontend=pkg.EnglishFrontend(pkg.TokenTextEncoder(
                pkg.default_arpabet_vocab())),
            sample_rate=100, vocoder=lambda mel: mel,
            text_to_mel=lambda t: chunks.append(t) or np.zeros(3, np.float32))
        if word_buckets:
            eng.ph_bucketer = make_bucketer((256,))
            eng.word_bucketer = make_bucketer(word_buckets)
        else:
            eng.bucketer = make_bucketer((32,))
        return eng

    got, ref = [], []
    list(tts.synthesize_stream(stub(ptext, Bucketer, got), text))
    list(jtts.synthesize_stream(stub(jtext, JaxBucketer, ref), text))
    assert got == ref and len(got) > 1
    if word_buckets:
        assert all(len(ptext.EnglishFrontend()(c).words) <= 6 for c in got)
