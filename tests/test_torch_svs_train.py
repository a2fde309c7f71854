"""The SVS and face training recipes against the JAX package's on the CPU:
``DiffSingerTask`` with the pitch embedding off (``diffsinger.yaml``'s
flags: FS2-MIDI with ``rel_pos``) and on (the f0 and uv terms), both
groups of ``VISingerTask`` (the posterior, the flow's KL, the whole-z
decoder, LSGAN, feature matching and the STFT magnitude), and
``Audio2MotionTask`` (the posterior heads, the antialiased resize under
grad): each loss term and every gradient against JAX's
``value_and_grad``; the VISinger critic untouched by the ``model`` step;
the training trees against the inference ones.

JAX's parameters come from ``jax.eval_shape`` filled with seeded numpy
(``test_torch_t2a._random_params``), so the layers JAX zero-initialises
(DiffNet's ``output_projection``, the coupling ``post`` layers) are random
and a comparison sees them. Draws are replayed from the key JAX's loss
gets: DiffSinger's t and ε of ``split(key)``, VISinger's and
Audio2Motion's posterior ε ``normal(key, ...)``. One compiled JAX program
a recipe (both groups in one for VISinger), shared by its tests.

Tolerances (f32): loss terms within 1e-5 relative, every gradient within
5e-5 of its tensor's largest; a gradient that vanishes (the keys' bias of
an attention) within 1e-7 of the group's largest gradient."""

import functools

import jax
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.face import audio2motion as ja2m
from audiogpt_tpu.models.svs import diffsinger as jds
from audiogpt_tpu.models.svs import visinger as jvis
from audiogpt_tpu.models.tts.fastspeech2 import \
    FastSpeech2Config as JaxFS2Config
from audiogpt_tpu.models.vocoder import discriminators as jdisc
from audiogpt_tpu.models.vocoder.hifigan import HifiGANConfig as JaxHifiGAN
from audiogpt_tpu.train.tasks import audio2motion as ja2m_task
from audiogpt_tpu.train.tasks import diffusion as jdiff_task
from audiogpt_tpu.train.tasks import visinger as jvis_task
from audiogpt_tpu_torch.engines.face import GeneFaceEngine
from audiogpt_tpu_torch.models.face.audio2motion import (Audio2MotionConfig,
                                                         Audio2MotionVAE)
from audiogpt_tpu_torch.models.svs import (DiffNetConfig, DiffSinger,
                                           DiffSingerConfig, VISinger,
                                           VISingerConfig)
from audiogpt_tpu_torch.models.tts.fastspeech2 import FastSpeech2Config
from audiogpt_tpu_torch.models.vocoder.discriminators import (
    DiscriminatorConfig, HifiGANDiscriminator)
from audiogpt_tpu_torch.models.vocoder.hifigan import HifiGANConfig
from audiogpt_tpu_torch.train import Trainer, TrainerConfig
from audiogpt_tpu_torch.train.tasks import (Audio2MotionTask,
                                            Audio2MotionTaskConfig,
                                            DiffSingerTask,
                                            DiffSingerTaskConfig,
                                            VISingerTask, VISingerTaskConfig)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_t2a import _random_params

torch.set_num_threads(2)

LOSS_RTOL, GRAD_RTOL, ZERO_GRAD_TOL = 1e-5, 5e-5, 1e-7
KEY = jax.random.PRNGKey(3)
B, T, F, M = 4, 10, 64, 16
FS2 = dict(use_midi=True, rel_pos=True, vocab_size=30, hidden_size=16,
           enc_layers=1, dec_layers=1, num_heads=2, enc_ffn_kernel_size=3,
           dec_ffn_kernel_size=3, dur_predictor_layers=1, predictor_layers=1,
           predictor_hidden=8, max_frames=F, n_mels=M)
NET = dict(mel_bins=M, encoder_hidden=16, residual_layers=2,
           residual_channels=8)
DS = dict(timesteps=50, K_step=40, spec_min=(-6.0,) * M,
          spec_max=(1.5,) * M)
VIS = dict(vocab_size=30, hidden=16, enc_layers=1, enc_heads=2, latent_dim=8,
           spec_bins=33, posterior_layers=2, flow_layers=2, flow_wn_layers=1,
           max_frames=F)
DEC = dict(in_channels=8, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))
#: narrow critics, all groups 1 (XLA's CPU grouped-conv backward is slow)
DISC = dict(periods=(2, 3), scales=2, period_channels=(4, 8),
            scale_channels=(8, 16, 16), scale_groups=(1, 1, 1))
A2M = dict(mel_bins=M, hidden=16, latent=4, conv_layers=2)
MEL_LEN = 64                    # → 25 video frames: the resize shrinks


def score_batch(seed=1, with_f0=True):
    """Three scored items (10, 7 and 4 phones over 64, 40 and 24 frames)
    and a row of zeros, as ``collate_tts`` pads a batch to its rung (weight
    0): the score fields, mel2ph, a voiced-and-unvoiced f0, a linear spec
    and the wav at hop 16."""
    rng = np.random.default_rng(seed)
    n_ph, n_fr = (10, 7, 4, 0), (64, 40, 24, 0)
    tok = np.zeros((B, T), np.int32)
    mel2ph = np.zeros((B, F), np.int32)
    for b in range(3):
        tok[b, :n_ph[b]] = rng.integers(3, 30, n_ph[b])
        cuts = np.sort(rng.choice(np.arange(1, n_fr[b]), n_ph[b] - 1,
                                  replace=False))
        parts = np.diff(np.concatenate([[0], cuts, [n_fr[b]]]))
        mel2ph[b, :n_fr[b]] = np.repeat(np.arange(1, n_ph[b] + 1), parts)
    valid = mel2ph > 0
    nonpad = tok > 0
    batch = {
        "txt_tokens": tok, "txt_lengths": np.asarray(n_ph, np.int32),
        "mels": (rng.uniform(-5.5, 1.0, (B, F, M)) * valid[..., None]
                 ).astype(np.float32),
        "mel_lengths": np.asarray(n_fr, np.int32), "mel2ph": mel2ph,
        "pitch_midi": (rng.integers(48, 80, (B, T)) * nonpad
                       ).astype(np.int32),
        "midi_dur": (rng.uniform(0.1, 0.6, (B, T)) * nonpad
                     ).astype(np.float32),
        "is_slur": ((rng.random((B, T)) < 0.3) * nonpad).astype(np.int32),
        "spec": (np.abs(rng.normal(size=(B, F, 33))) * valid[..., None]
                 ).astype(np.float32),
        "wav": (0.1 * rng.normal(size=(B, F * 16))
                * np.repeat(valid, 16, axis=1)).astype(np.float32),
        "weight": np.asarray([1, 1, 1, 0], np.float32)}
    if with_f0:
        batch["f0"] = (rng.uniform(100, 300, (B, F))
                       * (rng.random((B, F)) > 0.2) * valid
                       ).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_metrics(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)


def assert_grads(module, loss, jax_grads, build):
    """Every gradient of ``module``'s trainable params within
    ``GRAD_RTOL`` of its tensor's largest (a vanishing one within
    ``ZERO_GRAD_TOL`` of the group's largest). JAX's gradient tree goes
    through ``load_jax_params`` into ``build()``, so the layouts match by
    name."""
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    ref = build()
    load_jax_params(ref, jax_grads)
    ref = {n: p.detach() for n, p in ref.named_parameters()}
    assert sorted(ref) == sorted(n for n, _ in named)
    floor = ZERO_GRAD_TOL * max(float(v.abs().max()) for v in ref.values())
    for (n, _), g in zip(named, grads):
        r = ref[n].numpy()
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(
            g, r, rtol=0, atol=max(GRAD_RTOL * np.abs(r).max(), floor),
            err_msg=n)


# -- DiffSinger ---------------------------------------------------------------

def ds_configs(pitch_embed):
    jcfg = jds.DiffSingerConfig(
        fs2=JaxFS2Config(use_pitch_embed=pitch_embed, **FS2),
        net=jds.DiffNetConfig(**NET), **DS)
    cfg = DiffSingerConfig(
        fs2=FastSpeech2Config(use_pitch_embed=pitch_embed, **FS2),
        net=DiffNetConfig(**NET), **DS)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def ds_reference(pitch_embed):
    """JAX's ``DiffSingerTask._loss`` and its gradient in the model
    params, and the loss's draws: t of ``split(KEY)[0]``, ε of the
    second."""
    jcfg, _ = ds_configs(pitch_embed)
    jtask = jdiff_task.DiffSingerTask(jdiff_task.DiffSingerTaskConfig(
        model=jcfg))
    params = numpy_tree(_random_params(
        jax.eval_shape(jtask.init_params, KEY), seed=11))
    batch = score_batch()

    def loss(p):
        return jtask._loss({"model": p}, batch, KEY)

    def run(p):
        k1, k2 = jax.random.split(KEY)
        return (jax.value_and_grad(loss, has_aux=True)(p),
                jax.random.randint(k1, (B,), 0, jcfg.K_step),
                jax.random.normal(k2, (B, F, M)))

    ((value, metrics), grads), t, noise = jax.jit(run)(params["model"])
    draws = {"t": torch.from_numpy(np.array(t)),
             "noise": torch.from_numpy(np.array(noise))}
    return {"params": params, "batch": batch, "draws": draws,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": numpy_tree(grads)}


@pytest.mark.parametrize("pitch_embed", [False, True])
def test_diffsinger_loss_and_gradients_match_jax(pitch_embed):
    """``diffsinger.yaml``'s flags (no pitch embedding: ``diff``, ``pdur``,
    ``sdur``) and the f0 branch (``f0``, ``uv`` too): every term, and the
    gradient of every FS2-MIDI and DiffNet parameter."""
    ref = ds_reference(pitch_embed)
    assert np.abs(ref["params"]["model"]["params"]["denoiser"][
        "output_projection"]["kernel"]).min() > 0
    _, cfg = ds_configs(pitch_embed)
    task = DiffSingerTask(DiffSingerTaskConfig(model=cfg),
                          params=ref["params"], device="cpu")
    loss, metrics = task.loss(torch_batch(ref["batch"]),
                              draws=ref["draws"])
    assert_metrics(metrics, ref["metrics"])
    assert ("f0" in metrics) == pitch_embed
    assert_grads(task.model, loss, ref["grads"], lambda: DiffSinger(cfg))


def test_diffsinger_draws_and_uniform_fallback():
    """The trainer's draws: t in [0, K_step) and ε of the mel's shape from
    the generator (the same seed twice gives the same loss); a batch
    without ``mel2ph`` falls back to the uniform alignment and stays
    finite."""
    ref = ds_reference(False)
    _, cfg = ds_configs(False)
    task = DiffSingerTask(DiffSingerTaskConfig(model=cfg),
                          params=ref["params"], device="cpu")
    batch = torch_batch(ref["batch"])
    draws = task.draws(batch, torch.Generator().manual_seed(0))
    assert draws["noise"].shape == (B, F, M)
    assert 0 <= int(draws["t"].min()) and int(draws["t"].max()) < DS["K_step"]
    a = task.loss(batch, torch.Generator().manual_seed(5))[1]["total_loss"]
    b = task.loss(batch, torch.Generator().manual_seed(5))[1]["total_loss"]
    assert float(a) == float(b)
    batch.pop("mel2ph")
    assert torch.isfinite(task.loss(batch, torch.Generator())[0])


# -- VISinger -----------------------------------------------------------------

def vis_configs():
    jcfg = jvis.VISingerConfig(decoder=JaxHifiGAN(**DEC), **VIS)
    cfg = VISingerConfig(decoder=HifiGANConfig(**DEC), **VIS)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def vis_reference():
    """JAX's two groups in one program: ``_disc_loss`` in the critic's
    params, ``_model_loss`` in the model's, each group's ``_forward`` on
    the step's one key."""
    jcfg, _ = vis_configs()
    jtask = jvis_task.VISingerTask(jvis_task.VISingerTaskConfig(
        model=jcfg, disc=jdisc.DiscriminatorConfig(**DISC)))
    params = numpy_tree(_random_params(
        jax.eval_shape(jtask.init_params, KEY), seed=13))
    batch = score_batch(with_f0=False)

    def both(p):
        d = jax.value_and_grad(lambda d_: jtask._disc_loss(
            {"model": p["model"], "disc": d_}, batch, KEY),
            has_aux=True)(p["disc"])
        m = jax.value_and_grad(lambda m_: jtask._model_loss(
            {"model": m_, "disc": p["disc"]}, batch, KEY),
            has_aux=True)(p["model"])
        return d, m, jax.random.normal(KEY, (B, F, VIS["latent_dim"]))

    ((_, dm), dg), ((_, mm), mg), eps = jax.jit(both)(params)
    eps = torch.from_numpy(np.array(eps))
    return {"params": params, "batch": batch, "eps": eps,
            "disc": ({k: float(v) for k, v in dm.items()}, numpy_tree(dg)),
            "model": ({k: float(v) for k, v in mm.items()}, numpy_tree(mg))}


def vis_task(ref):
    _, cfg = vis_configs()
    return VISingerTask(VISingerTaskConfig(
        model=cfg, disc=DiscriminatorConfig(**DISC)), params=ref["params"],
        device="cpu")


@pytest.mark.parametrize("group", ["disc", "model"])
def test_visinger_groups_match_jax(group):
    """Each group's terms (``d_loss``; ``kl``, ``mel``, ``adv``, ``fm``,
    ``pdur``) and the gradient of every parameter of its group, with the
    posterior's ε replayed."""
    ref = vis_reference()
    tree = ref["params"]["model"]["params"]
    assert np.abs(tree["flow"]["l0"]["post"]["kernel"]).min() > 0
    task = vis_task(ref)
    fn = task.disc_loss if group == "disc" else task.model_loss
    loss, metrics = fn(torch_batch(ref["batch"]), draws=ref["eps"])
    want_metrics, want_grads = ref[group]
    assert_metrics(metrics, want_metrics)
    _, cfg = vis_configs()
    build = (lambda: HifiGANDiscriminator(DiscriminatorConfig(**DISC))) \
        if group == "disc" else (lambda: VISinger(cfg))
    assert_grads(task.modules[group], loss, want_grads, build)


def test_visinger_model_step_leaves_the_critic_untouched(tmp_path):
    """A trainer step of the ``model`` group moves the model, and leaves
    the critic's parameters (and their ``.grad``) as they were, though
    its loss reads the critic; then the ``disc`` step moves the critic."""
    ref = vis_reference()
    task = vis_task(ref)
    trainer = Trainer(task, TrainerConfig(work_dir=str(tmp_path),
                                          use_tensorboard=False),
                      device="cpu")
    batch = torch_batch(ref["batch"])
    disc0 = {n: p.detach().clone() for n, p in task.disc.named_parameters()}
    model0 = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    metrics = trainer.train_step("model", batch, seed=0)
    assert np.isfinite(float(metrics["total_loss"]))
    for n, p in task.disc.named_parameters():
        assert torch.equal(p, disc0[n]) and p.grad is None, n
    assert any(not torch.equal(p, model0[n])
               for n, p in task.model.named_parameters())
    trainer.train_step("disc", batch, seed=0)
    assert any(not torch.equal(p, disc0[n])
               for n, p in task.disc.named_parameters())


def test_visinger_inference_tree_is_the_training_tree():
    """JAX binds the posterior at init, so the task's model tree is the
    one the engine loads; the port's decoder takes ``latent_dim``
    channels whatever ``decoder.in_channels`` says (flax infers it)."""
    ref = vis_reference()
    _, cfg = vis_configs()
    load_jax_params(VISinger(cfg), ref["params"]["model"])
    import dataclasses

    wide = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, in_channels=80))
    model = VISinger(wide)
    assert model.decoder.state_dict()["conv_pre.Conv_0.weight"].shape[1] \
        == VIS["latent_dim"]
    load_jax_params(model, ref["params"]["model"])


# -- Audio2Motion -------------------------------------------------------------

def motion_batch(seed=2):
    rng = np.random.default_rng(seed)
    cfg = Audio2MotionConfig(**A2M)
    tv = cfg.video_len(MEL_LEN)
    mels = rng.uniform(0, 1, (B, MEL_LEN, M)).astype(np.float32)
    motion = np.stack([ja2m.pseudo_motion_targets(m, tv) for m in mels])
    motion += 0.01 * rng.normal(size=motion.shape).astype(np.float32)
    return {"mels": mels, "motion": motion.astype(np.float32),
            "weight": np.asarray([1, 1, 1, 0], np.float32)}


@functools.lru_cache(maxsize=None)
def a2m_reference():
    jtask = ja2m_task.Audio2MotionTask(ja2m_task.Audio2MotionTaskConfig(
        model=ja2m.Audio2MotionConfig(**A2M)))
    params = numpy_tree(_random_params(
        jax.eval_shape(jtask.init_params, KEY), seed=17))
    batch = motion_batch()

    def loss(p):
        return jtask._loss({"model": p}, batch, KEY)

    cfg = ja2m.Audio2MotionConfig(**A2M)

    def run(p):
        return (jax.value_and_grad(loss, has_aux=True)(p),
                jax.random.normal(KEY, (B, cfg.video_len(MEL_LEN),
                                        A2M["latent"])))

    ((_, metrics), grads), eps = jax.jit(run)(params["model"])
    eps = torch.from_numpy(np.array(eps))
    return {"params": params, "batch": batch, "eps": eps,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": numpy_tree(grads)}


def test_audio2motion_loss_and_gradients_match_jax():
    """``recon_loss``, ``kl_loss``, ``vel_loss`` and every gradient, the
    posterior heads and the audio encoder under the 64 → 25 frame resize
    (antialiased, as ``jax.image.resize``) included."""
    ref = a2m_reference()
    assert ref["batch"]["motion"].shape[1] == 25
    cfg = Audio2MotionConfig(**A2M)
    task = Audio2MotionTask(Audio2MotionTaskConfig(model=cfg),
                            params=ref["params"], device="cpu")
    loss, metrics = task.loss(torch_batch(ref["batch"]), draws=ref["eps"])
    assert_metrics(metrics, ref["metrics"])
    assert_grads(task.model, loss, ref["grads"],
                 lambda: Audio2MotionVAE(cfg, posterior=True))


def test_audio2motion_training_tree_drives_the_engine(tmp_path):
    """The training tree (with ``motion_enc`` and ``post_head``) loads
    strictly into the task's model and, through ``inference_tree``, into
    the engine's, which owns neither head; the engine then makes motion
    from it."""
    ref = a2m_reference()
    cfg = Audio2MotionConfig(**A2M)
    tree = ref["params"]["model"]
    assert {"motion_enc", "post_head"} <= set(tree["params"])
    eng = GeneFaceEngine(cfg, params=tree, video_size=32, buckets=(64,),
                         media_root=str(tmp_path), device="cpu")
    assert not hasattr(eng.model, "motion_enc")
    np.testing.assert_array_equal(
        eng.model.prior_head.weight.detach().numpy(),
        tree["params"]["prior_head"]["kernel"].T)
    mel = torch.from_numpy(ref["batch"]["mels"][0])
    lm = eng.motion(mel, draws=torch.zeros(1, 25, A2M["latent"]))
    assert lm.shape == (25, 68, 2) and torch.isfinite(lm).all()
