"""The analysis recipes against the JAX package's on the CPU: AudioSet
tagging (``SEDTask``: mixup with replayed draws, the weighted clipwise
BCE, the framewise term), audio captioning (``CaptionTask``: the
label-smoothed teacher-forced CE through Cnn14, the GRU and the decoder)
and separation (``SeparationTask``: PIT SI-SNR at one and two sources),
their collates, and ``train_cli`` on the three yamls.

JAX's variables come from ``jax.eval_shape`` filled with seeded numpy
(``test_torch_cnn14.random_variables``); each task compiles one JAX
``value_and_grad`` program (its variants batched into it) that its tests
share. Tolerances (f32): loss terms within 1e-6 relative, every gradient
within 5e-5 of its tensor's largest (a vanishing one within 1e-7 of the
group's largest)."""

import functools
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.data import loader as jloader
from audiogpt_tpu.models.caption.captioner import \
    CaptionConfig as JaxCaptionConfig
from audiogpt_tpu.models.caption.cnn14 import Cnn14Config as JaxCnn14Config
from audiogpt_tpu.models.sed.panns_sed import SEDConfig as JaxSEDConfig
from audiogpt_tpu.models.separation.convtasnet import \
    ConvTasNetConfig as JaxConvTasNetConfig
from audiogpt_tpu.train.tasks import caption as jcaption
from audiogpt_tpu.train.tasks import sed as jsed
from audiogpt_tpu.train.tasks import separation as jsep
from audiogpt_tpu_torch import train_cli
from audiogpt_tpu_torch.data import loader
from audiogpt_tpu_torch.models.caption.captioner import (CaptionConfig,
                                                         CaptionModel)
from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config
from audiogpt_tpu_torch.models.sed.panns_sed import SEDConfig, SEDModel
from audiogpt_tpu_torch.models.separation.convtasnet import (
    ConvTasNet, ConvTasNetConfig)
from audiogpt_tpu_torch.train import Trainer, TrainerConfig
from audiogpt_tpu_torch.train.tasks import (CaptionTask, CaptionTaskConfig,
                                            SEDTask, SEDTaskConfig,
                                            SeparationTask,
                                            SeparationTaskConfig)
from audiogpt_tpu_torch.train.tasks.sed import standard_gamma
from audiogpt_tpu_torch.train.tasks.separation import pit_si_snr, si_snr
from test_torch_cnn14 import random_variables
from test_torch_svs_train import assert_grads, numpy_tree, torch_batch
from test_train_cli import CASES, _write

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(11)
LOSS_RTOL = 1e-6
CHANNELS = (4, 4, 8, 8, 16, 16)
N_WAV = 32000                    # 1 s at 32 kHz: three Cnn14 frames
CLASSES = 10
CAPTION = dict(rnn_hidden=8, vocab_size=40, emb_dim=16, nhead=2, nlayers=1,
               dim_feedforward=32, max_caption_len=8)
TASNET = dict(enc_dim=32, bottleneck=8, hidden=16, skip=8, n_blocks=2,
              n_repeats=1, sample_rate=8000)
N_MIX = 4000


def assert_metrics(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)


def _clips(rng, b, n):
    t = np.arange(n) / 32000.0
    f = rng.uniform(200, 4000, b)[:, None]
    return (0.2 * rng.normal(size=(b, n))
            + 0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)


# -- the collates -------------------------------------------------------------

def test_collates_equal_jax_bitwise():
    """``collate_tagging`` and ``collate_mixture`` crop, pad and stack as
    JAX's, with a ``weight`` of ones: the same arrays, dtypes and keys."""
    rng = np.random.default_rng(0)
    tags = [{"wav": rng.normal(size=n).astype(np.float32),
             "target": (rng.random(CLASSES) < 0.3).astype(np.float32)}
            for n in (900, 1000, 1300)]
    mixes = [{"mix": rng.normal(size=n).astype(np.float32),
              "sources": rng.normal(size=(2, n)).astype(np.float32)}
             for n in (700, 1000, 1500)]
    for got, want in ((loader.collate_tagging(tags, 1000),
                       jloader.collate_tagging(tags, 1000)),
                      (loader.collate_mixture(mixes, 1000),
                       jloader.collate_mixture(mixes, 1000))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.all(got["weight"] == 1)


# -- SED ----------------------------------------------------------------------

def sed_batches(seed=2):
    """A batch with strong labels and a weight-0 row, and the same clips
    without either (three rows, shorter clips zero-padded). The strong
    labels cover the first Cnn14 frame (32 of 96 frames): JAX's f32 mean of
    the framewise term rounds by about 1e-6 relative at 2 700 terms (its
    value at 90 frames sits 1.2e-6 from the float64 mean, the port's
    within 3e-8), which the 1e-6 bar cannot tell from a fault."""
    rng = np.random.default_rng(seed)
    b = 3
    lens = np.asarray([N_WAV, 24000, 28000], np.int32)
    wav = _clips(rng, b, N_WAV) * (np.arange(N_WAV)[None] < lens[:, None])
    target = (rng.random((b, CLASSES)) < 0.3).astype(np.float32)
    full = {"wav": wav.astype(np.float32), "wav_len": lens,
            "target": target,
            "frame_target": (rng.random((b, 32, CLASSES)) < 0.2
                             ).astype(np.float32),
            "weight": np.asarray([1, 1, 0], np.float32)}
    bare = {k: full[k] for k in ("wav", "wav_len", "target")}
    return {"full": full, "bare": bare}


@functools.lru_cache(maxsize=None)
def sed_reference():
    jtask = jsed.SEDTask(jsed.SEDTaskConfig(model=JaxSEDConfig(
        cnn14=JaxCnn14Config(channels=CHANNELS), classes_num=CLASSES)))
    params = numpy_tree(random_variables(
        jax.eval_shape(jtask.init_params, KEY), seed=31))
    batches = sed_batches()
    stats = params["model"]["batch_stats"]

    def both(p):
        def vg(batch):
            batch = jax.tree.map(jnp.asarray, batch)
            return jax.value_and_grad(lambda q: jtask._loss(
                {"model": {"params": q, "batch_stats": stats}}, batch, KEY),
                has_aux=True)(p)
        # mixup's draws of the same key, as the loss makes them
        k1, k2 = jax.random.split(KEY)
        return ((vg(batches["full"]), vg(batches["bare"])),
                (jax.random.beta(k1, 1.0, 1.0, ()),
                 jax.random.permutation(k2, 3)))

    out, (lam, perm) = jax.jit(both)(params["model"]["params"])
    draws = {"lam": torch.tensor(float(lam)),
             "perm": torch.from_numpy(np.asarray(perm).astype(np.int64))}
    return {"params": params, "batches": batches, "draws": draws,
            **{name: ({k: float(v) for k, v in m.items()}, numpy_tree(g))
               for name, ((_, m), g) in zip(("full", "bare"), out)}}


def sed_task(ref):
    return SEDTask(SEDTaskConfig(model=SEDConfig(
        cnn14=Cnn14Config(channels=CHANNELS), classes_num=CLASSES)),
        params=ref["params"], device="cpu")


@pytest.mark.parametrize("variant", ["full", "bare"])
def test_sed_loss_and_gradients_match_jax(variant):
    """Mixup on JAX's λ and permutation of the step's key; ``clip_bce``
    (weighted, or the plain mean) and ``frame_bce`` with strong labels;
    every gradient of the model, with Cnn14 on its running statistics."""
    ref = sed_reference()
    task = sed_task(ref)
    loss, metrics = task.loss(torch_batch(ref["batches"][variant]),
                              draws=ref["draws"])
    want_metrics, want_grads = ref[variant]
    assert_metrics(metrics, want_metrics)
    assert ("frame_bce" in metrics) == (variant == "full")
    assert_grads(task.model, loss,
                 {"params": want_grads,
                  "batch_stats": ref["params"]["model"]["batch_stats"]},
                 lambda: SEDModel(SEDConfig(
                     cnn14=Cnn14Config(channels=CHANNELS),
                     classes_num=CLASSES)))


def test_sed_step_keeps_the_running_statistics(tmp_path):
    """A trainer step (mixup drawn from the trainer's generator) moves the
    weights and leaves every BatchNorm buffer as it was, also after
    ``model.train()``; the draws replay from one seed."""
    ref = sed_reference()
    task = sed_task(ref)
    task.model.train()
    assert not task.model.training
    buffers = {n: b.clone() for n, b in task.model.named_buffers()}
    assert any("running_mean" in n for n in buffers)
    fc0 = task.model.fc_frame.weight.detach().clone()
    trainer = Trainer(task, TrainerConfig(work_dir=str(tmp_path),
                                          use_tensorboard=False),
                      device="cpu")
    batch = torch_batch(ref["batches"]["full"])
    m = trainer.train_step("model", batch, seed=0)
    assert np.isfinite(float(m["total_loss"]))
    for n, b in task.model.named_buffers():
        assert torch.equal(b, buffers[n]), n
    assert not torch.equal(task.model.fc_frame.weight, fc0)
    a = task.draws(batch, torch.Generator().manual_seed(3))
    b = task.draws(batch, torch.Generator().manual_seed(3))
    assert torch.equal(a["lam"], b["lam"]) and torch.equal(a["perm"],
                                                           b["perm"])
    assert 0.0 < float(a["lam"]) < 1.0
    assert sorted(a["perm"].tolist()) == [0, 1, 2]


@pytest.mark.parametrize("alpha", [0.4, 1.0, 3.0])
def test_mixup_gamma_draws_have_the_gamma_moments(alpha):
    """``standard_gamma`` (Beta(α, α) = X/(X+Y)): 40 000 draws have the
    Gamma(α) mean α and variance α within 3 %, and the λ of Beta(α, α)
    the mean ½."""
    g = standard_gamma(alpha, 40000, torch.Generator().manual_seed(0),
                       torch.device("cpu")).double()
    assert float(g.min()) > 0
    assert float(g.mean()) == pytest.approx(alpha, rel=0.03)
    assert float(g.var()) == pytest.approx(alpha, rel=0.03 * 2)
    lam = g[:20000] / (g[:20000] + g[20000:])
    assert float(lam.mean()) == pytest.approx(0.5, abs=0.01)


# -- captioning ---------------------------------------------------------------

def caption_batch(seed=3):
    """Three clips with captions of 6, 4 and 5 tokens (<sos> first) in
    ``text_len`` 7, and a weight-0 row."""
    rng = np.random.default_rng(seed)
    b, text_len = 3, 7
    lens = np.asarray([N_WAV, 26000, 30000], np.int32)
    wav = _clips(rng, b, N_WAV) * (np.arange(N_WAV)[None] < lens[:, None])
    tok_len = np.asarray([6, 4, 5], np.int32)
    tokens = np.zeros((b, text_len), np.int32)
    for i, n in enumerate(tok_len):
        tokens[i, 1:n] = rng.integers(1, CAPTION["vocab_size"], n - 1)
    return {"wav": wav.astype(np.float32), "wav_len": lens, "tokens": tokens,
            "token_len": tok_len, "weight": np.asarray([1, 0, 1],
                                                       np.float32)}


@functools.lru_cache(maxsize=None)
def caption_reference():
    jtask = jcaption.CaptionTask(jcaption.CaptionTaskConfig(
        model=JaxCaptionConfig(cnn14=JaxCnn14Config(channels=CHANNELS),
                               **CAPTION)))
    params = numpy_tree(random_variables(
        jax.eval_shape(jtask.init_params, KEY), seed=33))
    batch = caption_batch()
    stats = params["model"]["batch_stats"]
    fn = jax.jit(jax.value_and_grad(lambda q: jtask._loss(
        {"model": {"params": q, "batch_stats": stats}}, batch, KEY),
        has_aux=True))
    (_, metrics), grads = fn(params["model"]["params"])
    return {"params": params, "batch": batch,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": numpy_tree(grads)}


def test_caption_loss_and_gradients_match_jax():
    """``ce`` (label smoothing 0.1, masked by ``token_len − 1`` and
    ``weight``), ``token_acc``, and every gradient: Cnn14 on its running
    statistics, the bidirectional GRU (JAX's padded-row reversal) under
    autograd, the decoder."""
    ref = caption_reference()
    cfg = CaptionConfig(cnn14=Cnn14Config(channels=CHANNELS), **CAPTION)
    task = CaptionTask(CaptionTaskConfig(model=cfg), params=ref["params"],
                       device="cpu")
    task.model.eval().train()
    assert not task.model.cnn.training and task.model.rnn.training
    loss, metrics = task.loss(torch_batch(ref["batch"]))
    assert_metrics(metrics, ref["metrics"])
    assert_grads(task.model, loss,
                 {"params": ref["grads"],
                  "batch_stats": ref["params"]["model"]["batch_stats"]},
                 lambda: CaptionModel(cfg))


# -- separation ---------------------------------------------------------------

def mixture_batch(n_src, seed=4):
    rng = np.random.default_rng(seed)
    b = 3
    t = np.arange(N_MIX) / 8000.0
    src = (0.3 * rng.normal(size=(b, n_src, N_MIX))
           + np.sin(2 * np.pi * rng.uniform(100, 1500, (b, n_src, 1)) * t)
           ).astype(np.float32)
    return {"mix": src.sum(1), "sources": src,
            "weight": np.asarray([1, 1, 0], np.float32)}


@functools.lru_cache(maxsize=None)
def separation_reference():
    out = {}
    tasks, params, batches = {}, {}, {}
    for n_src in (1, 2):
        tasks[n_src] = jsep.SeparationTask(jsep.SeparationTaskConfig(
            model=JaxConvTasNetConfig(n_src=n_src, **TASNET)))
        params[n_src] = numpy_tree(random_variables(
            jax.eval_shape(tasks[n_src].init_params, KEY), seed=35 + n_src))
        batches[n_src] = mixture_batch(n_src)

    def both(p1, p2):
        return tuple(jax.value_and_grad(
            lambda q, n=n: tasks[n]._loss({"model": q}, batches[n], KEY),
            has_aux=True)(p) for n, p in ((1, p1), (2, p2)))

    res = jax.jit(both)(params[1]["model"], params[2]["model"])
    for n_src, ((_, m), g) in zip((1, 2), res):
        out[n_src] = {"params": params[n_src], "batch": batches[n_src],
                      "metrics": {k: float(v) for k, v in m.items()},
                      "grads": numpy_tree(g)}
    return out


@pytest.mark.parametrize("n_src", [1, 2])
def test_separation_loss_and_gradients_match_jax(n_src):
    """The weighted −SI-SNR under the best permutation (one source:
    enhancement) and every gradient of Conv-TasNet."""
    ref = separation_reference()[n_src]
    cfg = ConvTasNetConfig(n_src=n_src, **TASNET)
    task = SeparationTask(SeparationTaskConfig(model=cfg),
                          params=ref["params"], device="cpu")
    loss, metrics = task.loss(torch_batch(ref["batch"]))
    assert_metrics(metrics, ref["metrics"])
    assert_grads(task.model, loss, ref["grads"], lambda: ConvTasNet(cfg))


def test_pit_si_snr_at_three_sources_matches_jax():
    """Six permutations at three sources, with one row whose estimate is
    its reference permuted (the best permutation recovers it), and
    ``si_snr``'s eps placement on a silent reference."""
    rng = np.random.default_rng(8)
    ref = rng.normal(size=(2, 3, 500)).astype(np.float32)
    est = (ref + 0.3 * rng.normal(size=ref.shape)).astype(np.float32)
    est[1] = ref[1][[2, 0, 1]]
    got = pit_si_snr(torch.from_numpy(est), torch.from_numpy(ref))
    want = np.asarray(jax.jit(jsep.pit_si_snr)(est, ref))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)
    assert len(list(itertools.permutations(range(3)))) == 6
    best = si_snr(torch.from_numpy(ref[1]), torch.from_numpy(ref[1])).mean()
    np.testing.assert_allclose(float(got[1]), float(best), rtol=LOSS_RTOL)
    silent = np.zeros((1, 100), np.float32)
    noise = rng.normal(size=(1, 100)).astype(np.float32)
    np.testing.assert_allclose(
        si_snr(torch.from_numpy(noise), torch.from_numpy(silent)).numpy(),
        np.asarray(jax.jit(jsep.si_snr)(noise, silent)), rtol=LOSS_RTOL)


# -- train_cli ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["sed", "caption", "separation"])
def test_train_cli_trains_and_resumes_the_analysis_recipes(name, tmp_path):
    """``train_cli.main`` on the repo's yaml at the JAX CLI test's tiny
    hparams: two steps on the CPU with finite terms, a checkpoint at step
    2, then a third step resumed from it."""
    cfg_path, hp, make_records = CASES[name]
    bin_dir = str(tmp_path / "bin")
    recs = make_records()
    _write(os.path.join(bin_dir, "train"), recs)
    exp = str(tmp_path / "exp")
    hparams = (f"data.binary_dir={bin_dir}," + hp
               + ",log_interval=1,val_check_interval=50,"
               "use_tensorboard=false")
    argv = ["--config", os.path.join(REPO, cfg_path), "--exp_name", exp,
            "--hparams", hparams, "--device", "cpu"]
    train_cli.main(argv + ["--max_updates", "2"])
    assert "2.pt" in os.listdir(os.path.join(exp, "ckpt"))
    train_cli.main(argv + ["--max_updates", "3"])
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        tr = [json.loads(line) for line in f]
    tr = [line for line in tr if line["prefix"] == "tr"]
    assert [line["step"] for line in tr] == [1, 2, 3]
    for line in tr:
        vals = [v for v in line.values() if isinstance(v, float)]
        assert vals and all(np.isfinite(vals))
    assert "3.pt" in os.listdir(os.path.join(exp, "ckpt"))
