"""The GenerSpeech and pitch-extractor training recipes and the emotion
data path against the JAX package's on the CPU: the ``vq_ema=False``
quantiser (its straight-through code, the commitment and codebook losses
and every gradient, the codebook's included), ``MixStyle`` with replayed
draws on both branches (and the port's own λ draws against JAX's Beta),
the training forward's ``vq_commit``, ``guided_attn``, ``postflow_nll``
and mel, ``GenerSpeechTask``'s and ``PETask``'s terms and gradients
against JAX's ``value_and_grad``, ``EmotionBinarizer``'s records,
``emo_map.json`` and the batch's ``emo_ids``, and ``train_cli`` training
``generspeech`` and ``pe`` on the port's records.

JAX's parameters come from ``jax.eval_shape`` filled with seeded numpy;
the post-flow's 1×1 convolutions get random orthogonal matrices, as JAX
initialises them (its log-determinant's gradient is the inverse, which a
random matrix's condition number would amplify). Each VQ choice is
checked to lie far from a tie. ``MixStyle``'s draws are JAX's: the
permutation, Beta(0.1, 0.1) λ and Bernoulli of ``split(r_mix, 3)``, with
``r_mix`` the first half of the loss key's split. One compiled JAX
program a recipe.

Tolerances (f32): loss terms within 1e-5 relative, forward outputs within
1e-5 of each array's largest, every gradient within 1e-4 of its tensor's
largest (a vanishing one, the keys' bias of an attention, within 1e-7
of the model's largest)."""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.data import binarizer as jbinarizer
from audiogpt_tpu.data import loader as jloader
from audiogpt_tpu.models.tts import fastspeech2 as jfs
from audiogpt_tpu.models.tts import generspeech as jgs
from audiogpt_tpu.models.tts.generspeech import GlobalStyleEncoder
from audiogpt_tpu.models.tts.pitch_extractor import \
    PitchExtractorConfig as JaxPEConfig
from audiogpt_tpu.train.tasks.generspeech import (
    GenerSpeechTask as JaxGSTask, GenerSpeechTaskConfig as JaxGSTaskConfig)
from audiogpt_tpu.train.tasks.pe import PETask as JaxPETask
from audiogpt_tpu.train.tasks.pe import PETaskConfig as JaxPETaskConfig
from audiogpt_tpu_torch import train_cli
from audiogpt_tpu_torch.data import (BinarizeConfig, EmotionBinarizer,
                                     collate_tts, load_emo_map, load_split)
from audiogpt_tpu_torch.models.tts import FastSpeech2Config
from audiogpt_tpu_torch.models.tts import generspeech as pgs
from audiogpt_tpu_torch.models.tts.pitch_extractor import (
    PitchExtractor, PitchExtractorConfig)
from audiogpt_tpu_torch.train.tasks import (GenerSpeechTask,
                                            GenerSpeechTaskConfig, PETask,
                                            PETaskConfig)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_fs2_train import fs2_batch
from test_torch_generspeech import FS2 as GS_FS2
from test_torch_generspeech import GS, vq_gap
from test_torch_portaspeech_train import (assert_close, assert_grads,
                                          assert_metrics, torch_batch)
from test_torch_t2a import _random_params
from test_train_cli import CASES

torch.set_num_threads(2)

MELS = GS_FS2["n_mels"]
KEY = jax.random.PRNGKey(5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mix_draws(key, b):
    """JAX ``MixStyle``'s draws of ``key`` (its ``rng``)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {"perm": torch.from_numpy(np.array(
                jax.random.permutation(k1, b))).long(),
            "lam": torch.from_numpy(np.array(
                jax.random.beta(k2, 0.1, 0.1, (b, 1, 1)))),
            "apply": torch.tensor(bool(jax.random.bernoulli(k3, 0.5)))}


def key_with_apply(value: bool):
    """The first key, counting up, whose ``MixStyle`` applies (or not)."""
    for i in range(100):
        key = jax.random.PRNGKey(i)
        if bool(jax.random.bernoulli(jax.random.split(key, 3)[2], 0.5)) \
                == value:
            return key
    raise AssertionError("no key")


def test_vq_codebook_loss_and_straight_through_grads_match_jax():
    """``vq_ema=False``: the code, the commitment plus codebook loss, and
    the gradients of ``sum(code · r) + loss`` in every parameter: the
    straight-through code sends its gradient to the encoder and none to
    the codebook, which learns from ``‖sg(h) − e‖²`` only."""
    jmod = jgs.LocalStyleAdaptor(16, 8, vq_ema=False)
    rng = np.random.default_rng(1)
    mel = (rng.normal(size=(2, 24, MELS)) - 3).astype(np.float32)
    nonpad = (np.arange(24)[None] < np.array([[24], [17]])).astype(
        np.float32)
    mel *= nonpad[..., None]
    r = rng.normal(size=(2, 24, 16)).astype(np.float32)
    params = jax.tree.map(np.array, _random_params(jax.eval_shape(
        jmod.init, KEY, mel, nonpad), seed=2))
    assert "vq_stats" not in params

    def f(p):
        quant, commit = jmod.apply(p, mel, nonpad)
        return (quant * r).sum() + commit, (quant, commit)

    (_, (quant_ref, commit_ref)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    mod = pgs.LocalStyleAdaptor(MELS, 16, 8, ema=False)
    load_jax_params(mod, params)
    assert isinstance(mod.vq.embedding, torch.nn.Parameter)
    with torch.no_grad():
        h = mod.encoder(torch.from_numpy(mel), torch.from_numpy(nonpad))
    assert vq_gap(h.numpy().reshape(-1, 16),
                  mod.vq.embedding.detach().numpy()) > 1e-3
    quant, commit = mod.losses(torch.from_numpy(mel),
                               torch.from_numpy(nonpad))
    assert_close(quant, quant_ref, "quant")
    np.testing.assert_allclose(float(commit), float(commit_ref), rtol=1e-5)
    # the straight-through code alone gives the codebook no gradient
    g_code, = torch.autograd.grad((quant * torch.from_numpy(r)).sum(),
                                  [mod.vq.embedding], allow_unused=True,
                                  retain_graph=True)
    assert g_code is None
    assert_grads(mod, (quant * torch.from_numpy(r)).sum() + commit,
                 jax.tree.map(np.asarray, grads),
                 lambda: pgs.LocalStyleAdaptor(MELS, 16, 8, ema=False))


@pytest.mark.parametrize("apply", [True, False])
def test_mixstyle_with_replayed_draws_matches_jax(apply):
    """Both branches of the batch's one Bernoulli; the std is the
    population one."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 10, 8)).astype(np.float32)
    cond = rng.normal(size=(4, 1, 8)).astype(np.float32)
    key = key_with_apply(apply)
    ref = jgs.MixStyle().apply({}, x, cond, train=True, rng=key)
    draws = mix_draws(key, 4)
    assert bool(draws["apply"]) == apply
    got = pgs.MixStyle()(torch.from_numpy(x), torch.from_numpy(cond), draws)
    assert_close(got, ref, "mixed")
    if not apply:
        np.testing.assert_array_equal(got.numpy(), x + cond)


def test_mixstyle_draws_from_a_generator():
    """The port's own draws: a permutation, λ in [0, 1] distributed as
    JAX's Beta(0.1, 0.1) (quantiles within 0.02 over 20 000 draws), and
    a Bernoulli(0.5)."""
    mix = pgs.MixStyle()
    g = torch.Generator().manual_seed(0)
    d = mix.draws(20000, g, torch.device("cpu"))
    assert sorted(d["perm"].tolist()) == list(range(20000))
    lam = d["lam"].flatten().numpy()
    assert lam.dtype == np.float32 and 0 <= lam.min() and lam.max() <= 1
    ref = np.asarray(jax.random.beta(KEY, 0.1, 0.1, (20000,)))
    qs = np.linspace(0.05, 0.95, 19)
    np.testing.assert_allclose(np.quantile(lam, qs), np.quantile(ref, qs),
                               atol=0.02)
    applies = [bool(mix.draws(2, g, torch.device("cpu"))["apply"])
               for _ in range(200)]
    assert 60 < sum(applies) < 140


def gs_batch():
    """``fs2_batch`` (a short item, a dummy row of weight 0, unvoiced
    frames) with the mel cut to the tiny model's bins."""
    batch = {k: v for k, v in fs2_batch().items()
             if k in ("txt_tokens", "txt_lengths", "mels", "mel_lengths",
                      "mel2ph", "f0", "weight")}
    batch["mels"] = (batch["mels"][..., :MELS] - 3.0 * (
        batch["mel2ph"] > 0)[..., None]).astype(np.float32)
    return batch


OUT_KEYS = ("mel_out", "vq_commit", "guided_attn", "postflow_nll",
            "pitch_pred", "dur")
INFER_KEYS = ("mel_out", "postflow_nll", "decoder_inp", "pitch_pred")


@functools.lru_cache(maxsize=None)
def gs_reference():
    """JAX's ``GenerSpeechTask`` (``vq_ema`` forced off): one compiled
    ``value_and_grad`` of ``_loss`` in the model params, its aux the loss
    terms and the training forward's outputs on the same key."""
    jcfg = jgs.GenerSpeechConfig(fs2=jfs.FastSpeech2Config(**GS_FS2), **GS)
    jtask = JaxGSTask(JaxGSTaskConfig(model=jcfg))
    assert not jtask.cfg.model.vq_ema
    params = jax.tree.map(np.array, _random_params(
        jax.eval_shape(jtask.init_params, KEY), seed=3))
    tree = params["model"]["params"]
    rng = np.random.RandomState(4)
    for step in tree["post_flow"].values():
        c = step["inv1x1_w"].shape[0]
        step["inv1x1_w"][:] = np.linalg.qr(rng.randn(c, c))[0]
    assert "embedding" in tree["style_utter"]["vq"]
    batch = gs_batch()
    uv = (batch["f0"] == 0).astype(np.float32)
    f0n = jfs.norm_f0(batch["f0"], uv, jcfg.fs2)
    # the loss's own forward, its outputs kept as they are traced
    seen, model = {}, jtask.model

    def apply(*args, **kw):
        seen.update(model.apply(*args, **kw))
        return seen

    jtask.model = types.SimpleNamespace(apply=apply)

    def loss(p):
        total, metrics = jtask._loss({"model": p}, batch, KEY)
        return total, (metrics, {k: seen[k] for k in OUT_KEYS})

    def run(p):
        (_, aux), grads = jax.value_and_grad(loss, has_aux=True)(p)
        # the inference forward on the same tree, outside the gradient: no
        # mixing, the VQ's codebook a param, the post-flow's NLL of the
        # predicted mel
        infer = model.apply(p, batch["txt_tokens"], batch["mels"],
                            mel2ph=batch["mel2ph"], f0=f0n, uv=uv,
                            infer_postflow=False)
        return aux, {k: infer[k] for k in INFER_KEYS}, grads

    (metrics, out), infer, grads = jax.jit(run)(params["model"])
    return {"params": params, "batch": batch,
            "metrics": jax.tree.map(np.asarray, metrics),
            "out": jax.tree.map(np.asarray, out),
            "infer": jax.tree.map(np.asarray, infer),
            "grads": jax.tree.map(np.asarray, grads),
            "draws": mix_draws(jax.random.split(KEY)[0], len(batch["f0"]))}


def gs_task(shared):
    return GenerSpeechTask(GenerSpeechTaskConfig(
        model=pgs.GenerSpeechConfig(fs2=FastSpeech2Config(**GS_FS2), **GS)),
        params=shared["params"], device="cpu")


def test_generspeech_training_forward_matches_jax():
    """``train=True`` with the mixing replayed: the VQ loss, the guided
    attention, the post-flow NLL of the target mel, the mel and the
    predictors."""
    shared = gs_reference()
    task = gs_task(shared)
    assert not task.cfg.model.vq_ema
    b = torch_batch(shared["batch"])
    uv = (b["f0"] == 0).float()
    f0n = (b["f0"] - 200.0) / 60.0 * (1 - uv)
    with torch.no_grad():
        h = task.model.style_utter.encoder(b["mels"], (b["mels"].abs().sum(
            -1) > 0).float())
        assert vq_gap(h.numpy().reshape(-1, h.shape[-1]),
                      task.model.style_utter.vq.embedding.numpy()) > 1e-3
        out = task.model(b["txt_tokens"].long(), b["mels"],
                         mel2ph=b["mel2ph"].long(), f0=f0n, uv=uv,
                         draws=shared["draws"], train=True)
    for k in OUT_KEYS:
        assert_close(out[k], shared["out"][k], k)


def test_vq_ema_false_tree_at_inference_matches_jax():
    """The training tree (codebooks as params, no ``vq_stats``) drives the
    inference forward as JAX's does on it: ``MixStyle`` the identity, the
    post-flow's NLL of the predicted mel."""
    shared = gs_reference()
    model = gs_task(shared).model.eval()
    b = torch_batch(shared["batch"])
    uv = (b["f0"] == 0).float()
    f0n = (b["f0"] - 200.0) / 60.0 * (1 - uv)
    with torch.no_grad():
        out = model(b["txt_tokens"].long(), b["mels"],
                    mel2ph=b["mel2ph"].long(), f0=f0n, uv=uv,
                    infer_postflow=False)
    for k in INFER_KEYS:
        assert_close(out[k], shared["infer"][k], k)


def test_generspeech_task_losses_and_grads_match_jax():
    shared = gs_reference()
    task = gs_task(shared)
    loss, metrics = task.loss(torch_batch(shared["batch"]),
                              draws=shared["draws"])
    assert {"mel", "commit", "guided", "ssim", "postflow", "pdur", "sdur",
            "f0", "uv"} <= set(metrics)
    assert_metrics(metrics, shared["metrics"])
    assert_grads(task.model, loss, shared["grads"],
                 lambda: pgs.GenerSpeech(task.cfg.model))


def test_pe_task_losses_and_grads_match_jax():
    """The pitch extractor's f0 L1 and uv BCE over the non-silent frames;
    the batch without ``uv`` takes uv = (f0 == 0), which JAX's task reads
    from the batch."""
    model = dict(n_mels=MELS, hidden=16, prenet_layers=2, conv_layers=1,
                 predictor_layers=2)
    jtask = JaxPETask(JaxPETaskConfig(model=JaxPEConfig(**model)))
    params = jax.tree.map(np.array, _random_params(
        jax.eval_shape(jtask.init_params, KEY), seed=6))
    batch = gs_batch()
    batch["uv"] = (batch["f0"] == 0).astype(np.float32)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jtask._loss({"model": p}, batch, KEY), has_aux=True))(
        params["model"])
    task = PETask(PETaskConfig(model=PitchExtractorConfig(**model)),
                  params=params, device="cpu")
    without_uv = {k: v for k, v in torch_batch(batch).items() if k != "uv"}
    for b in (torch_batch(batch), without_uv):
        loss, got = task.loss(b)
        assert_metrics(got, metrics)
    assert_grads(task.model, loss, jax.tree.map(np.asarray, grads),
                 lambda: PitchExtractor(task.cfg.model))


def emotion_items(module, n=8, sr=22050):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        t = np.arange(int(sr * (0.3 + 0.05 * (i % 3)))) / sr
        wav = (0.3 * np.sin(2 * np.pi * (160 + 15 * (i % 4)) * t)
               + 0.01 * rng.normal(size=len(t))).astype(np.float32)
        frames = 1 + len(t) // 256
        out.append(module.Item(
            name=f"esd{i}", wav=wav, phones=["HH", "AH0", "L", "OW1"],
            durations=[frames // 4] * 3 + [frames - 3 * (frames // 4)],
            spk=f"spk{i % 2}",
            emotion=["Neutral", "Happy", "Sad"][i % 3]))
    return out


@pytest.fixture(scope="module")
def emotion_bins(tmp_path_factory):
    """Both packages' ``EmotionBinarizer`` (f0, style embeddings with the
    JAX encoder's params passed across) on the same tagged items."""
    root = tmp_path_factory.mktemp("emo")
    params = _random_params(jax.eval_shape(
        GlobalStyleEncoder().init, KEY, jnp.zeros((1, 16, 80))), seed=3)
    cfg = dict(with_f0=True, with_style_embed=True, valid_fraction=0.25)
    jbinarizer.EmotionBinarizer(jbinarizer.BinarizeConfig(**cfg),
                                style_params=params).binarize(
        emotion_items(jbinarizer), str(root / "jax"))
    counts = EmotionBinarizer(BinarizeConfig(**cfg), style_params=params,
                              device="cpu").binarize(
        emotion_items(jbinarizer), str(root / "port"))
    return root, counts


def test_emotion_binarizer_matches_jax(emotion_bins):
    """``emo_map.json``, each record's ``emo_id`` and ids, the embeddings
    within 1e-4, and the batch's ``emo_ids`` from both collates."""
    root, counts = emotion_bins
    assert counts == {"test": 0, "valid": 2, "train": 6}
    assert load_emo_map(str(root / "port")) == \
        jbinarizer.load_emo_map(str(root / "jax")) == \
        {"Happy": 0, "Neutral": 1, "Sad": 2}
    port = load_split(str(root / "port"), "train")
    ref = jbinarizer.load_split(str(root / "jax"), "train")
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert sorted(a) == sorted(b)
        for key in ("emo_id", "spk_id", "item_name", "len"):
            assert a[key] == b[key], key
        np.testing.assert_array_equal(a["mel2ph"], b["mel2ph"])
        np.testing.assert_allclose(a["mel"], b["mel"], atol=1e-4)
        for key in ("spk_embed", "emo_embed"):
            np.testing.assert_allclose(a[key], b[key], atol=1e-4)
    recs = [port[i] for i in range(len(port))]
    got = collate_tts(recs, None)
    want = jloader.collate_tts([ref[i] for i in range(len(ref))], None, 80)
    assert got["emo_ids"].dtype == want["emo_ids"].dtype == np.int32
    np.testing.assert_array_equal(got["emo_ids"], want["emo_ids"])
    assert got["emo_ids"].tolist() == [recs[i]["emo_id"]
                                      for i in range(len(recs))]


@pytest.mark.parametrize("name", ["generspeech", "pe"])
def test_train_cli_trains_generspeech_and_pe(emotion_bins, tmp_path, name):
    """``train_cli.main`` on the port's emotion records, ``generspeech``
    with the JAX CLI test's hparams (``tests/test_train_cli.py``) and
    ``pe`` narrowed alike: finite terms at every step, a checkpoint."""
    root, _ = emotion_bins
    hp = {"generspeech": CASES["generspeech"][1].replace(
              "model.fs2.vocab_size=30", "model.fs2.vocab_size=120"),
          "pe": "model.hidden=16,model.conv_layers=1,"
                "model.predictor_layers=2,optim.schedule=constant,"
                "optim.lr=0.001,data.max_tokens=400,data.max_sentences=8,"
                "data.max_len=128,data.max_batch=8,data.min_batch=8"}[name]
    exp = str(tmp_path / "exp")
    train_cli.main([
        "--config", os.path.join(REPO, "configs", "tts", f"{name}.yaml"),
        "--exp_name", exp, "--max_updates", "2", "--device", "cpu",
        "--hparams", f"data.binary_dir={root / 'port'},"
        + hp + ",num_sanity_val_steps=0,log_interval=1,"
        "val_check_interval=50,use_tensorboard=false"])
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        tr = [line for line in map(json.loads, f) if line["prefix"] == "tr"]
    terms = {"generspeech": {"mel", "commit", "guided", "postflow", "f0",
                             "uv"}, "pe": {"f0", "uv"}}[name]
    assert [line["step"] for line in tr] == [1, 2]
    for line in tr:
        assert terms <= set(line) and line["nonfinite"] == 0
        assert all(np.isfinite(v) for v in line.values()
                   if isinstance(v, float))
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["2.json",
                                                             "2.pt"]
