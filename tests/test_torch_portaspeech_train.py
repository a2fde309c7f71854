"""The PortaSpeech training recipes against the JAX package's on the CPU:
the posterior encoder, the training forward with the graph off and on
(the model has three speakers and the batch's items carry speaker ids),
``PortaSpeechTask``'s loss terms (the KL at three points of its ramp, the
sentence-duration term) and every gradient against JAX's
``value_and_grad``, the multi-window critic, both groups of
``PortaSpeechAdvTask`` and ``AdvTTSTask``, the training and inference
trees and the engine on a training tree, and ``train_cli`` building the
four PortaSpeech names and training ``ps_adv`` from records the port
binarized with words and graphs.

JAX's parameters come from ``jax.eval_shape`` filled with seeded numpy
(``test_torch_t2a._random_params``), so the layers JAX zero-initialises
(``FVAEEncoder.proj``, ``CondCoupling.post``) are random too and a
comparison sees them; the tests check that. Draws are replayed: ε is
``jax.random.normal(rng, …)`` of the key the JAX loss gets, each window's
start JAX's ``randint`` of ``fold_in(rng, window)``. One compiled JAX
program a recipe, shared by its tests; ``PortaSpeechTask`` and ``ps_adv``
share one (``ps_program``: ``ps_adv``'s ``_model_loss`` at
``lambda_adv`` 0 is ``PortaSpeechTask``'s loss).

Tolerances (f32): loss terms within 1e-5 relative, forward outputs within
1e-5 of each array's largest, every gradient within 1e-4 of its tensor's
largest; a gradient that vanishes (the keys' bias of an attention: a
softmax ignores a shift of its logits, so both sides hold rounding noise,
≈ 1e-10 to 1e-8 of the model's largest gradient) within 1e-7 of the
model's largest gradient."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu import text as jtext
from audiogpt_tpu.models.tts import portaspeech as jps
from audiogpt_tpu.models.tts.fastspeech2 import \
    FastSpeech2Config as JaxFS2Config
from audiogpt_tpu.train.tasks import tts_adv as jadv
from audiogpt_tpu.train.tasks.fs2 import FS2TaskConfig as JaxFS2TaskConfig
from audiogpt_tpu.train.tasks.portaspeech import (
    PortaSpeechTask as JaxPSTask, PortaSpeechTaskConfig as JaxPSTaskConfig)
from audiogpt_tpu_torch import train_cli
from audiogpt_tpu_torch.data import (BinarizeConfig, Item, RecordWriter,
                                     TTSBinarizer, load_split)
from audiogpt_tpu_torch.engines.tts import PortaSpeechTTSEngine
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.tts import portaspeech as pps
from audiogpt_tpu_torch.models.tts.fastspeech2 import (FastSpeech2,
                                                       FastSpeech2Config)
from audiogpt_tpu_torch.models.vocoder.hifigan import HifiGANConfig
from audiogpt_tpu_torch.text.frontend import EnglishFrontend
from audiogpt_tpu_torch.train.tasks import (AdvTTSTask, AdvTTSTaskConfig,
                                            FS2TaskConfig,
                                            PortaSpeechAdvTask,
                                            PortaSpeechAdvTaskConfig,
                                            PortaSpeechTask,
                                            PortaSpeechTaskConfig)
from audiogpt_tpu_torch.train.tasks.tts_adv import MultiWindowDiscriminator
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_fs2_train import MODEL as FS2_MODEL
from test_torch_fs2_train import fs2_batch
from test_torch_t2a import _random_params
from test_train_cli import CASES

torch.set_num_threads(2)

LOSS_RTOL, FWD_RTOL, GRAD_RTOL, ZERO_GRAD_TOL = 1e-5, 1e-5, 1e-4, 1e-7
M = 16                                  # mel bins of the tiny models
PH_VOCAB = len(jtext.default_arpabet_vocab()) + 3
PS = dict(ph_vocab_size=PH_VOCAB, word_vocab_size=20, hidden_size=16,
          enc_layers=1, word_enc_layers=1, num_heads=2,
          enc_ffn_kernel_size=3, dur_predictor_layers=1, n_mels=M,
          max_frames=64, latent_size=4, fvae_hidden=8, fvae_enc_layers=2,
          fvae_dec_layers=1, prior_flow_hidden=8, prior_flow_blocks=2,
          graph_steps=2, num_spk=3)
KL_START = 100
SPK_IDS = (1, 3, 1, 0)
STEPS = (0, 50, 250)                    # the ramp at 0, ½ and past it
WINDOWS, DISC_HIDDEN = (8, 16), 8
B, T, W, F = 4, 12, 6, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(7)


def ps_batch(seed=1, graph=False):
    """Three items (12, 9 and 7 phones over 6, 4 and 3 words; 64, 48 and
    36 frames; speakers 1, 3 and 1) and a padded row of zeros, as
    ``collate_tts`` pads a batch to its rung (weight 0, mel length 0,
    speaker 0)."""
    rng = np.random.default_rng(seed)
    batch = {k: np.zeros(s, np.int32) for k, s in (
        ("txt_tokens", (B, T)), ("ph2word", (B, T)),
        ("word_tokens", (B, W)), ("mel2word", (B, F)))}
    n_ph, n_w, n_fr = (12, 9, 7, 0), (6, 4, 3, 0), (64, 48, 36, 0)
    for b in range(3):
        batch["txt_tokens"][b, :n_ph[b]] = rng.integers(3, PH_VOCAB,
                                                        n_ph[b])
        batch["ph2word"][b, :n_ph[b]] = np.sort(np.concatenate([
            np.arange(1, n_w[b] + 1),
            rng.integers(1, n_w[b] + 1, n_ph[b] - n_w[b])]))
        batch["word_tokens"][b, :n_w[b]] = rng.integers(3, 20, n_w[b])
        cuts = np.sort(rng.choice(np.arange(1, n_fr[b]), n_w[b] - 1,
                                  replace=False))
        parts = np.diff(np.concatenate([[0], cuts, [n_fr[b]]]))
        batch["mel2word"][b, :n_fr[b]] = np.repeat(np.arange(1, n_w[b] + 1),
                                                   parts)
    valid = batch["mel2word"] > 0
    batch["mels"] = (rng.normal(size=(B, F, M)) * valid[..., None]
                     ).astype(np.float32)
    batch["mel_lengths"] = np.asarray(n_fr, np.int32)
    batch["word_lengths"] = np.asarray(n_w, np.int32)
    batch["weight"] = np.asarray([1, 1, 1, 0], np.float32)
    batch["spk_ids"] = np.asarray(SPK_IDS, np.int32)
    if graph:
        words = np.arange(W)[None] < batch["word_lengths"][:, None]
        adj = rng.random((B, 6, W, W)) < 0.3
        batch["graph_adj"] = (adj * words[:, None, :, None]
                              * words[:, None, None, :]).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def eps_of(batch):
    """The posterior's ε as JAX's loss draws it from ``KEY``, traced in the
    reference program that returns it."""
    b, f = batch["mels"].shape[:2]
    return jax.random.normal(KEY, (b, f // 4, PS["latent_size"]))


def jax_starts(key, mel_len, windows=WINDOWS):
    """JAX's raw window starts (before its clamp) for ``key``."""
    lo = int(np.min(mel_len))
    return torch.tensor([int(jax.random.randint(
        jax.random.fold_in(key, wi), (), 0, max(max(lo - win, 0), 1)))
        for wi, win in enumerate(windows)])


def ps_params(jtask, seed):
    """JAX's task tree, filled; JAX's ``init_params`` calls the model
    without a speaker, so flax makes no speaker table and JAX's recipe
    cannot train at ``num_spk > 0`` (``ROADMAP.md`` §C): the table is
    added here, as the port's model builds it."""
    params = jax.tree.map(np.array, _random_params(
        jax.eval_shape(jtask.init_params, KEY), seed=seed))
    tree = params["model"]["params"]
    assert "spk_embed" not in tree
    tree["spk_embed"] = {"embedding": np.random.default_rng(seed).normal(
        size=(PS["num_spk"] + 1, PS["hidden_size"])).astype(np.float32)}
    for leaf in (tree["fvae_enc"]["proj"]["kernel"],
                 tree["prior_flow"]["f0"]["post"]["kernel"]):
        assert np.abs(leaf).min() > 0       # zero-initialised in JAX
    return params


def assert_grads(module, loss, jax_grads, build):
    """Every gradient of ``module``'s params within ``GRAD_RTOL`` of its
    tensor's largest; JAX's gradient tree goes through ``load_jax_params``
    into ``build()``, so the layouts match by name. → the gradients by
    name."""
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, list(module.parameters()),
                                allow_unused=True)
    ref = build()
    load_jax_params(ref, jax_grads)
    ref = ref.state_dict()
    assert sorted(ref) == sorted(names)
    floor = ZERO_GRAD_TOL * max(float(v.abs().max()) for v in ref.values())
    for n, g in zip(names, grads):
        r = ref[n].numpy()
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(
            g, r, rtol=0, atol=max(GRAD_RTOL * np.abs(r).max(), floor),
            err_msg=n)
    return dict(zip(names, grads))


def assert_metrics(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)


def assert_close(got, ref, key):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=FWD_RTOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=key)


OUT_KEYS = ("mel_out", "kl", "dur", "z_p", "m_q", "logs_q", "attn")


PS_TASK = JaxPSTaskConfig(model=jps.PortaSpeechConfig(**PS),
                          lambda_sent_dur=0.5, kl_start_steps=KL_START)


@functools.lru_cache(maxsize=None)
def ps_program():
    """One compiled JAX program that both recipes' tests share: JAX's
    ``PortaSpeechAdvTask`` on ``PS_TASK`` (graph off, sentence term on)
    with the step and ``lambda_adv`` traced → the critic's terms and the
    gradient of ``_disc_loss`` in ``disc``; the terms, the training
    forward's outputs and the gradient of ``_model_loss`` in ``model``.
    ``_model_loss`` is ``PortaSpeechTask``'s loss plus ``lambda_adv`` ×
    the adversarial term, so at ``lambda_adv`` 0 it is
    ``PortaSpeechTask``'s value and gradient (its ``adv`` term 0)."""

    def run(params, batch, step, lambda_adv):
        jtask = jadv.PortaSpeechAdvTask(jadv.PortaSpeechAdvTaskConfig(
            ps=PS_TASK, disc_windows=WINDOWS, disc_hidden=DISC_HIDDEN,
            lambda_adv=lambda_adv))
        batch = dict(batch, step=step)
        seen, forward = {}, jtask.ps_task.forward_and_losses

        def keep(*args):
            total, metrics, out = forward(*args)
            seen.update(out)
            return total, metrics, out

        jtask.ps_task.forward_and_losses = keep
        (_, d_m), g_d = jax.value_and_grad(
            lambda pd: jtask._disc_loss({**params, "disc": pd}, batch, KEY),
            has_aux=True)(params["disc"])

        def model_loss(pm):
            total, metrics = jtask._model_loss({**params, "model": pm},
                                               batch, KEY)
            return total, (metrics, {k: seen[k] for k in OUT_KEYS})

        (_, (m_m, out)), g_m = jax.value_and_grad(
            model_loss, has_aux=True)(params["model"])
        return d_m, g_d, m_m, out, g_m, eps_of(batch)

    jtask = jadv.PortaSpeechAdvTask(jadv.PortaSpeechAdvTaskConfig(
        ps=PS_TASK, disc_windows=WINDOWS, disc_hidden=DISC_HIDDEN))
    return jtask, jax.jit(run)


def ps_run(params, batch, step, lambda_adv):
    _, fn = ps_program()
    return jax.tree.map(np.array, fn(params, batch, jnp.int32(step),
                                     jnp.float32(lambda_adv)))


@functools.lru_cache(maxsize=None)
def ps_reference():
    """``PortaSpeechTask`` at each of ``STEPS``: the shared program at
    ``lambda_adv`` 0, its ``adv`` term dropped from the loss terms."""
    jtask, _ = ps_program()
    params = ps_params(jtask, seed=5)
    batch = ps_batch()
    runs = {}
    for step in STEPS:
        _, _, metrics, out, grads, eps = ps_run(params, batch, step, 0.0)
        assert float(metrics.pop("adv")) == 0.0
        runs[step] = (metrics, out, grads)
    return {"params": {"model": params["model"]}, "batch": batch,
            "runs": runs, "eps": torch.from_numpy(eps)}


def ps_task(params, **kw):
    return PortaSpeechTask(PortaSpeechTaskConfig(
        model=pps.PortaSpeechConfig(**{**PS, **kw}), lambda_sent_dur=0.5,
        kl_start_steps=KL_START), params=params, device="cpu")


def test_fvae_encoder_matches_jax():
    """The posterior on a length that is a multiple of 4: kernel 8, stride
    4, flax's SAME padding (2 frames before, 2 after), the zero-initialised
    projection filled."""
    cfg = jps.PortaSpeechConfig(**PS)
    rng = np.random.default_rng(3)
    mels = rng.normal(size=(2, 32, M)).astype(np.float32)
    cond = rng.normal(size=(2, 8, 16)).astype(np.float32)
    mask = (np.arange(8)[None, :, None] < np.array([8, 5])[:, None, None]
            ).astype(np.float32)
    jmod = jps.FVAEEncoder(cfg)
    params = jax.tree.map(np.array, _random_params(jax.eval_shape(
        jmod.init, KEY, mels, cond, mask), seed=4))
    assert np.abs(params["params"]["proj"]["kernel"]).min() > 0
    m_ref, logs_ref = jax.jit(jmod.apply)(params, mels, cond, mask)
    mod = pps.FVAEEncoder(pps.PortaSpeechConfig(**PS))
    load_jax_params(mod, params)
    with torch.no_grad():
        m, logs = mod(*(torch.from_numpy(a) for a in (mels, cond, mask)))
    assert m.shape == (2, 8, PS["latent_size"])
    assert_close(m, m_ref, "m")
    assert_close(logs, logs_ref, "logs")


def test_training_forward_matches_jax():
    """The training branch with ε replayed (the graph off, speakers on):
    the mel, the KL, the word durations, the posterior and the
    prior-space latent."""
    shared = ps_reference()
    task = ps_task(shared["params"])
    batch = torch_batch(shared["batch"])
    with torch.no_grad():
        out = task.model.train_forward(
            batch["txt_tokens"].long(), batch["word_tokens"].long(),
            batch["ph2word"].long(), batch["mel2word"].long(),
            batch["mels"], draws=shared["eps"],
            spk_id=batch["spk_ids"].long())
    ref = shared["runs"][STEPS[0]][1]
    for k in OUT_KEYS:
        assert_close(out[k], ref[k], k)


def test_syntaspeech_training_forward_and_losses_match_jax():
    """``use_graph``: the GGNN in the duration predictor and the prior's
    condition, on a batch with a random typed word graph."""
    jtask = JaxPSTask(JaxPSTaskConfig(
        model=jps.PortaSpeechConfig(**PS, use_graph=True),
        kl_start_steps=KL_START))
    params = ps_params(jtask, seed=6)
    assert np.abs(params["model"]["params"]["prior_graph_proj"]["kernel"]
                  ).min() > 0
    batch = ps_batch(2, graph=True)
    (total, metrics, out), eps = jax.jit(lambda p, b: (
        jtask.forward_and_losses(p, b, KEY), eps_of(b)))(params, batch)
    task = PortaSpeechTask(PortaSpeechTaskConfig(
        model=pps.PortaSpeechConfig(**PS, use_graph=True),
        kl_start_steps=KL_START), params=params, device="cpu")
    with torch.no_grad():
        got_total, got, got_out = task.forward_and_losses(
            torch_batch(batch), torch.from_numpy(np.array(eps)))
    assert_metrics(got, metrics)
    for k in ("mel_out", "kl", "dur", "z_p"):
        assert_close(got_out[k], out[k], k)


@pytest.mark.parametrize("step", STEPS)
def test_portaspeech_task_losses_match_jax(step):
    """Every term, ``sdur`` included, at step 0 (the KL off), half the ramp
    and past it (trouble spot: the trainer's ``batch["step"]``)."""
    shared = ps_reference()
    task = ps_task(shared["params"])
    metrics, _, _ = shared["runs"][step]
    batch = dict(torch_batch(shared["batch"]), step=step)
    _, got = task.loss(batch, draws=shared["eps"])
    assert_metrics(got, metrics)
    ramp = min(step / KL_START, 1.0)
    np.testing.assert_allclose(float(got["kl"]), float(got["kl_v"]) * ramp,
                               rtol=1e-6)
    assert {"sdur", "wdur", "ssim"} <= set(got)


def test_portaspeech_task_grads_match_jax():
    """Every gradient; the speaker table's is non-zero exactly on the rows
    of the batch's real items (1 and 3; the padded row's speaker 0 reaches
    no loss)."""
    shared = ps_reference()
    task = ps_task(shared["params"])
    batch = dict(torch_batch(shared["batch"]), step=STEPS[1])
    loss, _ = task.loss(batch, draws=shared["eps"])
    grads = assert_grads(task.model, loss, shared["runs"][STEPS[1]][2],
                         lambda: pps.PortaSpeech(task.cfg.model,
                                                 posterior=True))
    table = grads["spk_embed.weight"]
    assert torch.nonzero(table.abs().sum(1)).flatten().tolist() == [1, 3]


@pytest.mark.parametrize("lengths", [(24, 17, 0), (24, 20, 19), (40, 40, 40)],
                         ids=["padded", "full", "past-the-canvas"])
def test_multi_window_discriminator_matches_jax(lengths):
    """The critic on three crops of a [3, 24, 16] mel with JAX's starts:
    a padded row (length 0) puts every window at frame 0; full rows draw
    below the shortest; lengths past the canvas draw starts that the
    clamp to ``T − win`` must stop (as ``dynamic_slice`` does)."""
    jdisc = jadv.MultiWindowDiscriminator(WINDOWS, DISC_HIDDEN)
    rng = np.random.default_rng(4)
    mel = rng.normal(size=(3, 24, M)).astype(np.float32)
    mel_len = np.asarray(lengths, np.int32)
    params = jax.tree.map(np.array, _random_params(jax.eval_shape(
        jdisc.init, KEY, mel, mel_len, KEY), seed=8))
    key = jax.random.PRNGKey(11)
    ref = _disc_program(jdisc)(params, mel, mel_len, key)
    starts = jax_starts(key, mel_len)
    if lengths[-1] == 0:
        assert starts.tolist() == [0, 0]
    elif lengths[0] > 24:
        assert int(starts[0]) > 24 - WINDOWS[0]      # the clamp binds
    else:
        assert starts.max() > 0
    disc = MultiWindowDiscriminator(M, WINDOWS, DISC_HIDDEN)
    load_jax_params(disc, params)
    with torch.no_grad():
        got = disc(torch.from_numpy(mel), starts)
    assert got.shape == (3, 1)
    assert_close(got, ref, "validity")


@functools.lru_cache(maxsize=None)
def _disc_program(jdisc):
    return jax.jit(jdisc.apply)


def _adv_reference(jtask, params, batch):
    """Both groups' losses and the gradients of each in its own params, one
    compiled program (``_disc_loss`` in ``disc``, ``_model_loss`` in
    ``model``), the same key for both, as JAX's trainer gives."""

    def both(p):
        (_, d_m), g_d = jax.value_and_grad(
            lambda pd: jtask._disc_loss({**p, "disc": pd}, batch, KEY),
            has_aux=True)(p["disc"])
        (_, m_m), g_m = jax.value_and_grad(
            lambda pm: jtask._model_loss({**p, "model": pm}, batch, KEY),
            has_aux=True)(p["model"])
        return d_m, g_d, m_m, g_m

    return jax.tree.map(np.asarray, jax.jit(both)(params))


@functools.lru_cache(maxsize=None)
def ps_adv_reference():
    """``ps_adv`` at its own ``lambda_adv``, the step past the ramp."""
    jtask, _ = ps_program()
    params = ps_params(jtask, seed=9)
    batch = ps_batch(3)
    d_m, g_d, m_m, _, g_m, eps = ps_run(params, batch, KL_START,
                                         jtask.cfg.lambda_adv)
    return params, batch, (d_m, g_d, m_m, g_m), torch.from_numpy(eps)


@pytest.mark.parametrize("group", ["disc", "model"])
def test_ps_adv_groups_match_jax(group):
    """``ps_adv``'s two steps on the padded batch (every crop at frame 0)
    with ε and the starts replayed: each group's terms and the gradient of
    its own params (the critic's in ``disc``, the generator's in
    ``model``)."""
    params, batch, (d_m, g_d, m_m, g_m), eps = ps_adv_reference()
    task = PortaSpeechAdvTask(PortaSpeechAdvTaskConfig(
        ps=PortaSpeechTaskConfig(model=pps.PortaSpeechConfig(**PS),
                                 lambda_sent_dur=0.5,
                                 kl_start_steps=KL_START),
        disc_windows=WINDOWS, disc_hidden=DISC_HIDDEN), params=params,
        device="cpu")
    assert list(task.loss_fns) == ["disc", "model"]
    draws = {"eps": eps,
             "starts": jax_starts(KEY, batch["mel_lengths"])}
    assert draws["starts"].tolist() == [0, 0]
    loss, metrics = task.loss_fns[group](torch_batch(batch), draws=draws)
    if group == "disc":
        assert_metrics(metrics, d_m)
        assert_grads(task.disc, loss, g_d, lambda: MultiWindowDiscriminator(
            M, WINDOWS, DISC_HIDDEN))
    else:
        assert_metrics(metrics, m_m)
        assert_grads(task.model, loss, g_m, lambda: pps.PortaSpeech(
            task.cfg.ps.model, posterior=True))


@functools.lru_cache(maxsize=None)
def adv_tts_reference():
    model = dict(FS2_MODEL, n_mels=M)
    jtask = jadv.AdvTTSTask(jadv.AdvTTSTaskConfig(
        fs2=JaxFS2TaskConfig(model=JaxFS2Config(**model)),
        disc_windows=WINDOWS, disc_hidden=DISC_HIDDEN))
    params = jax.tree.map(np.array, _random_params(
        jax.eval_shape(jtask.init_params, KEY), seed=10))
    batch = fs2_batch()
    batch["mels"] = np.ascontiguousarray(batch["mels"][..., :M])
    return model, params, batch, _adv_reference(jtask, params, batch)


@pytest.mark.parametrize("group", ["disc", "model"])
def test_adv_tts_groups_match_jax(group):
    """``AdvTTSTask`` (FastSpeech2 and the critic): the critic's mel comes
    from a forward fed the raw f0 (JAX's ``_gen_mel``), the recipe's terms
    from the normalised one; both groups' terms and gradients."""
    model, params, batch, (d_m, g_d, m_m, g_m) = adv_tts_reference()
    task = AdvTTSTask(AdvTTSTaskConfig(
        fs2=FS2TaskConfig(model=FastSpeech2Config(**model)),
        disc_windows=WINDOWS, disc_hidden=DISC_HIDDEN), params=params,
        device="cpu")
    draws = {"starts": jax_starts(KEY, batch["mel_lengths"])}
    assert draws["starts"].max() > 0
    loss, metrics = task.loss_fns[group](torch_batch(batch), draws=draws)
    if group == "disc":
        assert_metrics(metrics, d_m)
        assert_grads(task.disc, loss, g_d, lambda: MultiWindowDiscriminator(
            M, WINDOWS, DISC_HIDDEN))
    else:
        assert {"adv", "mel", "f0", "uv"} <= set(metrics)
        assert_metrics(metrics, m_m)
        assert_grads(task.model, loss, g_m,
                     lambda: FastSpeech2(task.cfg.fs2.model))


def test_training_and_inference_trees_and_the_engine():
    """The training tree (with ``fvae_enc``) loads strictly into the
    training model and not into the inference one; JAX's inference tree
    loads strictly into the inference model; the engine runs from the
    training tree (its posterior dropped) and gives the inference model's
    mel."""
    params = ps_reference()["params"]["model"]
    cfg = pps.PortaSpeechConfig(**PS)
    with pytest.raises(RuntimeError, match="fvae_enc"):
        load_jax_params(pps.PortaSpeech(cfg), params)
    inference = jax.eval_shape(lambda: jps.PortaSpeech(
        jps.PortaSpeechConfig(**PS)).init(
        KEY, *(jnp.ones((1, n), jnp.int32) for n in (8, 4, 8)), infer=True,
        spk_id=jnp.zeros((1,), jnp.int32), rng=KEY))
    assert "fvae_enc" not in inference["params"]
    assert set(params["params"]) - set(inference["params"]) == {"fvae_enc"}
    model = pps.PortaSpeech(cfg).eval()
    load_jax_params(model, jax.tree.map(np.array, _random_params(
        inference, seed=2)))
    eng = PortaSpeechTTSEngine(
        cfg, params=params, vocoder=VocoderEngine(
            "hifigan", cfg=HifiGANConfig(
                in_channels=M, upsample_initial_channel=16,
                upsample_rates=(16,), upsample_kernel_sizes=(32,),
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),)),
            buckets=(64,), device="cpu"),
        token_buckets=(32,), word_buckets=(16,), device="cpu")
    load_jax_params(model, pps.inference_tree(params))
    noise = torch.randn(1, PS["max_frames"] // 4, PS["latent_size"],
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(**eng.inputs("hello world"), draws=noise,
                    noise_scale=eng.noise_scale)["mel_out"][0].numpy()
    mel = eng.text_to_mel("hello world", draws=noise)
    assert mel.shape[1] == M and np.isfinite(mel).all()
    np.testing.assert_array_equal(mel, ref[:len(mel)])


def test_train_cli_builds_the_portaspeech_family():
    """``build_task`` on the four names from the shipped configs at full
    width (``synta_adv``: ``syntaspeech.yaml`` with the task renamed, the
    critic at its defaults)."""
    for config, task_name in (("portaspeech", None), ("syntaspeech", None),
                              ("ps_adv", None),
                              ("syntaspeech", "synta_adv")):
        over = f"task={task_name}" if task_name else ""
        cfg = train_cli.load_config(
            os.path.join(REPO, "configs", "tts", f"{config}.yaml"),
            overrides=over)
        task = train_cli.build_task(cfg, device="cpu")
        m = task.model.cfg
        assert (m.hidden_size, m.latent_size, m.fvae_enc_layers) == \
            (192, 16, 8)
        assert m.use_graph == ("synta" in (task_name or config))
        assert hasattr(task.model, "fvae_enc")
        if "adv" in (task_name or config):
            assert list(task.loss_fns) == ["disc", "model"]
            assert task.cfg.lambda_adv == 0.05
            assert task.disc.time_lengths == (32, 64, 128)


def word_corpus(n=10, sr=22050, hop=256, seed=0):
    """Items with text, each phone of the port's frontend a share of the
    item's frames, so the binarizer writes ``mel2ph`` and ``mel2word``."""
    rng = np.random.default_rng(seed)
    frontend = EnglishFrontend()
    texts = ["hello world, how are you?", "a lazy dog sat down.",
             "the cat is here"]
    items = []
    for i in range(n):
        text = texts[i % len(texts)]
        samples = int(sr * (0.4 + 0.05 * (i % 3)))
        frames = 1 + samples // hop
        n_ph = len(frontend(text).phones)
        dur = np.full(n_ph, frames // n_ph)
        dur[:frames % n_ph] += 1
        t = np.arange(samples) / sr
        wav = (0.3 * np.sin(2 * np.pi * (150 + 10 * i) * t)
               + 0.01 * rng.normal(size=samples)).astype(np.float32)
        items.append(Item(name=f"w{i}", wav=wav, text=text,
                          durations=dur.tolist()))
    return items


def test_train_cli_trains_and_resumes_ps_adv(tmp_path, capsys):
    """``train_cli.main`` with ``configs/tts/ps_adv.yaml`` narrowed by the
    JAX CLI test's PortaSpeech hparams, on records binarized with words and
    graphs: both groups' terms finite; a second call resumes."""
    bin_dir = tmp_path / "bin"
    TTSBinarizer(BinarizeConfig(with_f0=False, with_words=True,
                                with_graph=True, valid_fraction=0.2),
                 device="cpu").binarize(word_corpus(), str(bin_dir))
    rec = load_split(str(bin_dir), "train")[0]
    assert {"word_tokens", "ph2word", "mel2word", "graph_adj"} <= set(rec)
    hp = (f"data.binary_dir={bin_dir}," + CASES["portaspeech"][1]
          + f",model.ph_vocab_size={PH_VOCAB},model.word_vocab_size=100,"
          "adv.disc_windows=[8, 16],"
          "adv.disc_hidden=8,num_sanity_val_steps=1,log_interval=1,"
          "val_check_interval=2,use_tensorboard=false")
    exp = str(tmp_path / "exp")
    argv = ["--config", os.path.join(REPO, "configs", "tts", "ps_adv.yaml"),
            "--exp_name", exp, "--hparams", hp, "--device", "cpu"]
    train_cli.main(argv + ["--max_updates", "2"])
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["2.json",
                                                             "2.pt"]
    assert "mel_0_2.png" in os.listdir(os.path.join(exp, "figures"))
    train_cli.main(argv + ["--max_updates", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    tr = [line for line in lines if line["prefix"] == "tr"]
    assert [line["step"] for line in tr] == [1, 2, 3]
    for line in tr:
        assert {"d_loss", "adv", "mel", "kl", "kl_v", "wdur"} <= set(line)
        assert all(np.isfinite(v) for v in line.values()
                   if isinstance(v, float))


def test_word_set_past_the_vocab_is_refused(tmp_path):
    """An id past ``model.word_vocab_size`` (or the phone set past
    ``ph_vocab_size``) would be a device-side assert on the card."""
    with RecordWriter(str(tmp_path / "train")) as w:
        w.add({"len": 4, "tokens": np.ones(4, np.int32),
               "mel": np.zeros((8, 80), np.float32)})
    for name, n in (("word_set.json", 30), ("phone_set.json", 10)):
        with open(tmp_path / name, "w") as f:
            json.dump([f"w{i}" for i in range(n)], f)
    path = os.path.join(REPO, "configs", "tts", "portaspeech.yaml")
    for over, field in (("model.word_vocab_size=20", "word_vocab_size"),
                        ("model.ph_vocab_size=5", "ph_vocab_size")):
        cfg = train_cli.load_config(
            path, overrides=f"data.binary_dir={tmp_path},{over}")
        with pytest.raises(ValueError, match=field):
            train_cli.build_loaders(cfg, "ps_adv")
    cfg = train_cli.load_config(path, overrides=f"data.binary_dir={tmp_path}")
    batches, _ = train_cli.build_loaders(cfg, "portaspeech")
    assert next(batches)["txt_tokens"].shape[0] == 8
