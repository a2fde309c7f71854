"""The LDM family's other two recipes against the JAX package's on the
CPU: the first-stage VAE GAN (``VAETask``, both groups, and its
``PatchDiscriminator`` with flax's SAME padding on odd and even images)
and CLAP pretraining (``CLAPTask``: both towers and the learned
temperature, the masked InfoNCE with padded rows, the clip of
``logit_scale``, and Cnn14 on its running statistics under the trainer):
each loss term and every gradient against JAX's ``value_and_grad``.

JAX's variables come from ``jax.eval_shape`` filled with seeded numpy
(``test_torch_cnn14.random_variables``: BatchNorm variances positive).
The VAE posterior's sample is replayed: ``normal(key, mean.shape)`` in
JAX's NHWC, transposed to NCHW. Tolerances (f32): loss terms within 1e-5
relative, every gradient within 5e-5 of its tensor's largest; a gradient
that vanishes within 1e-7 of the group's largest gradient."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.caption.cnn14 import Cnn14Config as JaxCnn14Config
from audiogpt_tpu.models.diffusion import VAEConfig as JaxVAEConfig
from audiogpt_tpu.models.textenc.bert import BertConfig as JaxBertConfig
from audiogpt_tpu.models.textenc.clap import \
    CLAPTextConfig as JaxCLAPTextConfig
from audiogpt_tpu.train.tasks import clap as jclap
from audiogpt_tpu.train.tasks import vae as jvae
from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config
from audiogpt_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from audiogpt_tpu_torch.models.textenc.bert import BertConfig
from audiogpt_tpu_torch.models.textenc.clap import CLAPTextConfig
from audiogpt_tpu_torch.train import Trainer, TrainerConfig
from audiogpt_tpu_torch.train.tasks import (CLAPTask, CLAPTaskConfig,
                                            VAETask, VAETaskConfig)
from audiogpt_tpu_torch.train.tasks.clap import CLAPModel, masked_infonce
from audiogpt_tpu_torch.train.tasks.vae import PatchDiscriminator
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_cnn14 import random_variables
from test_torch_svs_train import (assert_grads, assert_metrics, numpy_tree,
                                  torch_batch)

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(5)
#: ch 64: each of GroupNorm's 32 groups holds two channels or more, as at
#: the real ch 128 (with one channel a group, the bias of the conv before a
#: norm has no gradient at all, and both frameworks hold rounding noise)
VAE = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           resolution=16)
IMG = (2, 16, 20)               # batch, mel bins, frames
BERT = dict(vocab_size=100, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32, max_position=32)
CHANNELS = (4, 4, 8, 8, 16, 16)
D_PROJ, L, N_WAV = 16, 8, 16000


# -- the VAE GAN --------------------------------------------------------------

def vae_batch(seed=3):
    rng = np.random.default_rng(seed)
    b, h, w = IMG
    return {"mels": rng.uniform(-1, 1, (b, h, w, 1)).astype(np.float32),
            "weight": np.ones(b, np.float32)}


@functools.lru_cache(maxsize=None)
def vae_reference():
    """Both groups of JAX's ``VAETask`` in one program, and the posterior
    sample's ε of the step's key."""
    jtask = jvae.VAETask(jvae.VAETaskConfig(vae=JaxVAEConfig(**VAE)))
    params = numpy_tree(random_variables(
        jax.eval_shape(jtask.init_params, KEY), seed=21))
    batch = vae_batch()
    # the posterior's shape alone: traced, not run
    post = jax.eval_shape(lambda: jtask.vae.apply(
        params["model"], jnp.asarray(batch["mels"]), method=jtask.vae.encode))

    def both(p):
        d = jax.value_and_grad(lambda d_: jtask._disc_loss(
            {"model": p["model"], "disc": d_}, batch, KEY),
            has_aux=True)(p["disc"])
        m = jax.value_and_grad(lambda m_: jtask._model_loss(
            {"model": m_, "disc": p["disc"]}, batch, KEY),
            has_aux=True)(p["model"])
        return d, m, jax.random.normal(KEY, post.mean.shape)

    ((_, dm), dg), ((_, mm), mg), eps = jax.jit(both)(params)
    eps = np.array(eps)
    return {"params": params, "batch": batch,
            "eps": torch.from_numpy(eps.transpose(0, 3, 1, 2)),
            "disc": ({k: float(v) for k, v in dm.items()}, numpy_tree(dg)),
            "model": ({k: float(v) for k, v in mm.items()}, numpy_tree(mg))}


def vae_task(ref):
    return VAETask(VAETaskConfig(vae=VAEConfig(**VAE)), params=ref["params"],
                   device="cpu")


@pytest.mark.parametrize("group", ["disc", "model"])
def test_vae_groups_match_jax(group):
    """``d_loss``; ``rec``, ``kl`` (per element), ``g_adv``; and the
    gradient of every parameter of the group (the critic's LayerNorms, the
    VAE's one attention block at the 8 × 10 level)."""
    ref = vae_reference()
    task = vae_task(ref)
    fn = task.disc_loss if group == "disc" else task.model_loss
    loss, metrics = fn(torch_batch(ref["batch"]), draws=ref["eps"])
    want_metrics, want_grads = ref[group]
    assert_metrics(metrics, want_metrics)
    build = PatchDiscriminator if group == "disc" \
        else (lambda: AutoencoderKL(VAEConfig(**VAE)))
    assert_grads(task.modules[group], loss, want_grads, build)


def test_vae_model_step_leaves_the_critic_untouched(tmp_path):
    """The ``model`` step moves the VAE and leaves the critic and its
    ``.grad`` as they were; both groups draw the same posterior sample
    from one seed."""
    ref = vae_reference()
    task = vae_task(ref)
    trainer = Trainer(task, TrainerConfig(work_dir=str(tmp_path),
                                          use_tensorboard=False),
                      device="cpu")
    batch = torch_batch(ref["batch"])
    disc0 = {n: p.detach().clone() for n, p in task.disc.named_parameters()}
    vae0 = {n: p.detach().clone() for n, p in task.vae.named_parameters()}
    m = trainer.train_step("model", batch, seed=0)
    assert np.isfinite(float(m["total_loss"]))
    for n, p in task.disc.named_parameters():
        assert torch.equal(p, disc0[n]) and p.grad is None, n
    assert any(not torch.equal(p, vae0[n])
               for n, p in task.vae.named_parameters())
    x = task._image(batch)
    a, _ = task.reconstruct(x, torch.Generator().manual_seed(4))
    b, _ = task.reconstruct(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)


@pytest.mark.parametrize("hw", [(16, 20), (15, 23)])
def test_patch_discriminator_same_padding_matches_jax(hw):
    """The critic's logits on an even-sized and an odd-sized image: flax's
    SAME padding of the stride-2 4×4 convs is (1, 1) on an even axis and
    (1, 2) on an odd one, (1, 2) at stride 1; the LayerNorms run over the
    channels."""
    jdisc = jvae.PatchDiscriminator()
    x = np.random.default_rng(7).normal(size=(2, *hw, 1)).astype(np.float32)
    params = numpy_tree(random_variables(
        jax.eval_shape(jdisc.init, KEY, x), seed=23))
    ref = np.asarray(jax.jit(jdisc.apply)(params, x))
    disc = PatchDiscriminator()
    load_jax_params(disc, params)
    with torch.no_grad():
        got = disc(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, -(-hw[0] // 4), -(-hw[1] // 4), 1)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# -- CLAP pretraining ---------------------------------------------------------

def clap_batch(seed=4):
    """Three clips (1 s, and two shorter ones zero-padded) with their
    captions, and a row of weight 0 (0.69 s, one Cnn14 frame). A row with
    no Cnn14 frame (under 9 920 samples), such as the zero-length row that ``ArrayDataLoader``
    pads the last batch of an epoch with, makes the loss NaN in both
    frameworks (``ROADMAP.md`` §C)."""
    rng = np.random.default_rng(seed)
    b = 4
    t = np.arange(N_WAV) / 16000.0
    wav = 0.2 * rng.normal(size=(b, N_WAV)) + 0.5 * np.sin(
        2 * np.pi * np.asarray([220.0, 880.0, 3000.0, 440.0])[:, None] * t)
    lens = np.asarray([N_WAV, 12000, 14000, 11000])
    wav = wav * (np.arange(N_WAV)[None] < lens[:, None])
    ids = np.zeros((b, L), np.int32)
    for i, n in enumerate((8, 5, 6, 3)):
        ids[i, :n] = rng.integers(3, 100, n)
    return {"wav": wav.astype(np.float32), "wav_len": lens.astype(np.int32),
            "text_ids": ids, "text_mask": (ids != 0).astype(np.int32),
            "weight": np.asarray([1, 1, 1, 0], np.float32)}


@functools.lru_cache(maxsize=None)
def clap_reference():
    jtask = jclap.CLAPTask(jclap.CLAPTaskConfig(
        text=JaxCLAPTextConfig(bert=JaxBertConfig(**BERT), d_proj=D_PROJ),
        d_proj=D_PROJ, audio=JaxCnn14Config(channels=CHANNELS)))
    shapes = jax.eval_shape(jtask.init_params, KEY)
    shapes["model"]["params"].pop("logit_scale")
    params = numpy_tree(random_variables(shapes, seed=25))
    params["model"]["params"]["logit_scale"] = np.float32(np.log(1 / 0.07))
    batch = clap_batch()

    def loss(p, scale):
        p = {"params": {**p["params"], "logit_scale": scale},
             "batch_stats": p["batch_stats"]}
        return jtask._loss({"model": p}, batch, KEY)

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    out = {}
    for name, scale in (("init", np.log(1 / 0.07)), ("clipped", 5.0)):
        (_, metrics), (g, g_scale) = fn(params["model"],
                                        jnp.float32(scale))
        g = numpy_tree(g)
        g["params"]["logit_scale"] = np.asarray(g_scale)
        out[name] = ({k: float(v) for k, v in metrics.items()}, g["params"])
    return {"params": params, "batch": batch, **out}


def clap_task(ref):
    return CLAPTask(CLAPTaskConfig(
        text=CLAPTextConfig(bert=BertConfig(**BERT), d_proj=D_PROJ),
        d_proj=D_PROJ, audio=Cnn14Config(channels=CHANNELS)),
        params=ref["params"], device="cpu")


@pytest.mark.parametrize("point", ["init", "clipped"])
def test_clap_loss_and_gradients_match_jax(point):
    """``nce_a``, ``nce_t``, ``scale``, ``acc`` and every gradient, both
    towers and ``logit_scale``, with a padded row; at the clip
    (``logit_scale`` 5 > log 100) the scale is 100 and its gradient 0."""
    ref = clap_reference()
    task = clap_task(ref)
    if point == "clipped":
        with torch.no_grad():
            task.model.logit_scale.fill_(5.0)
    loss, metrics = task.loss(torch_batch(ref["batch"]))
    want_metrics, want_grads = ref[point]
    assert_metrics(metrics, want_metrics)
    if point == "clipped":
        assert float(metrics["scale"]) == pytest.approx(100.0, rel=1e-6)
        assert float(want_grads["logit_scale"]) == 0.0
        assert float(torch.autograd.grad(
            loss, task.model.logit_scale, retain_graph=True)[0]) == 0.0
    # Cnn14's statistics ride along so the gradient tree loads strictly
    want_grads = {"params": want_grads,
                  "batch_stats": ref["params"]["model"]["batch_stats"]}
    assert_grads(task.model, loss, want_grads, lambda: CLAPModel(
        CLAPTextConfig(bert=BertConfig(**BERT), d_proj=D_PROJ), D_PROJ,
        Cnn14Config(channels=CHANNELS)))


def test_masked_infonce_with_padded_rows():
    """Padded rows weigh 0 and their columns leave every softmax: the loss
    equals the unpadded batch's, whatever the padded logits hold; JAX's
    ``_masked_infonce`` agrees."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(5, 5)).astype(np.float32) * 3
    w = np.asarray([1, 1, 1, 0, 0], np.float32)
    got = masked_infonce(torch.from_numpy(logits), torch.from_numpy(w))
    ref = jclap.CLAPTask._masked_infonce(jnp.asarray(logits), jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    inner = masked_infonce(torch.from_numpy(logits[:3, :3]),
                           torch.ones(3))
    np.testing.assert_allclose(float(got), float(inner), rtol=1e-6)
    noisy = logits.copy()
    noisy[3:] = 1e3
    noisy[:, 3:] = 1e3
    again = masked_infonce(torch.from_numpy(noisy), torch.from_numpy(w))
    np.testing.assert_allclose(float(again), float(got), rtol=1e-6)


def test_clap_step_keeps_cnn14_running_statistics(tmp_path):
    """A trainer step moves the towers and the temperature and leaves every
    BatchNorm buffer of Cnn14 as it was (the tower stays in eval mode,
    JAX's ``train=False``), also after ``model.train()``."""
    ref = clap_reference()
    task = clap_task(ref)
    task.model.train()
    assert not task.model.audio.training and task.model.text.training
    buffers = {n: b.clone() for n, b in task.model.named_buffers()}
    assert any("running_var" in n for n in buffers)
    params0 = {n: p.detach().clone()
               for n, p in task.model.named_parameters()}
    trainer = Trainer(task, TrainerConfig(work_dir=str(tmp_path),
                                          use_tensorboard=False),
                      device="cpu")
    m = trainer.train_step("model", torch_batch(ref["batch"]), seed=0)
    assert np.isfinite(float(m["total_loss"]))
    for n, b in task.model.named_buffers():
        assert torch.equal(b, buffers[n]), n
    assert not torch.equal(task.model.logit_scale, params0["logit_scale"])
    assert not torch.equal(task.model.audio.backbone.fc1.weight,
                           params0["audio.backbone.fc1.weight"])


def test_clap_training_tree_loads_into_the_scorer():
    """The JAX CLAP task's tree loads strictly into ``CLAPTask`` and its
    towers' subtrees (the audio tower with Cnn14's statistics) into the
    ranking path's ``CLAPScorer``, with the same weights."""
    from audiogpt_tpu_torch.models.textenc import CLAPScorer

    ref = clap_reference()
    tree = ref["params"]["model"]
    scorer = CLAPScorer(
        CLAPTextConfig(bert=BertConfig(**BERT), d_proj=D_PROJ),
        text_params=tree["params"]["text"],
        audio_params={"params": tree["params"]["audio"],
                      "batch_stats": tree["batch_stats"]["audio"]},
        audio_cfg=Cnn14Config(channels=CHANNELS), sample_rate=16000,
        device="cpu")
    task = clap_task(ref)
    for name, tower in (("text", scorer.text), ("audio", scorer.audio)):
        mine = getattr(task.model, name).state_dict()
        for key, value in tower.state_dict().items():
            assert torch.equal(value, mine[key]), (name, key)
