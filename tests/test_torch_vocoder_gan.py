"""The HiFi-GAN vocoder GAN recipe against the JAX package's on the CPU: the
MPD and MSD logits and every feature map (the SAME padding of strided
convs, the average pool between scales, the period reshape with and
without its reflect pad, the group counts), the multi-resolution STFT,
LSGAN and feature-matching losses, both groups' losses and gradients
against JAX's ``value_and_grad`` (one compiled program for both groups),
two trainer steps, and ``train_cli`` on ``vocoder_gan``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.vocoder import discriminators as jdisc
from audiogpt_tpu.models.vocoder.hifigan import HifiGANConfig as JaxHifiGAN
from audiogpt_tpu.train import stft_loss as jstft
from audiogpt_tpu.train.tasks import VocoderGANTask as JaxGANTask
from audiogpt_tpu.train.tasks import VocoderGANTaskConfig as JaxGANConfig
from audiogpt_tpu_torch import train_cli
from audiogpt_tpu_torch.data import RecordWriter
from audiogpt_tpu_torch.models.vocoder import (HifiGANConfig,
                                               HifiGANGenerator)
from audiogpt_tpu_torch.models.vocoder import discriminators as disc
from audiogpt_tpu_torch.train import Trainer, TrainerConfig, stft_loss
from audiogpt_tpu_torch.train.tasks import (VocoderGANTask,
                                            VocoderGANTaskConfig)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_t2a import _random_params
from test_train_cli import CASES, _tts_records

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the generator of ``tests/test_train.py``'s GAN case
GEN = dict(in_channels=20, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))
#: narrow discriminators for the gradients: groups all 1 (XLA's CPU
#: grouped-conv backward is a slow path)
DISC = dict(periods=(2, 3), scales=2, period_channels=(4, 8),
            scale_channels=(8, 16, 16), scale_groups=(1, 1, 1))
#: f32: the losses relative to each, the gradients against each tensor's
#: largest; the feature maps and logits after up to 8 layers of convs
LOSS_RTOL, GRAD_RTOL, FMAP_ATOL = 1e-5, 1e-4, 1e-4


def to_torch_layout(fmap):
    fmap = np.asarray(fmap)
    return fmap.transpose(0, 3, 1, 2) if fmap.ndim == 4 \
        else fmap.transpose(0, 2, 1)


@pytest.mark.parametrize("length", [1000, 1003])
def test_discriminator_logits_and_feature_maps_match_jax(length):
    """Every period (2, 3, 5, 7, 11) and 3 scales with the reference's
    kernel, stride and group schedules at narrow widths (groups 1, 4, 16,
    16, 16, 16, 1): a length that 2 and 5 divide (no reflect pad there) and
    one that no period divides, both odd after the first pool."""
    kw = dict(period_channels=(4, 8, 16, 16),
              scale_channels=(16, 16, 32, 32, 64, 64, 64))
    jd = jdisc.HifiGANDiscriminator(jdisc.DiscriminatorConfig(**kw))
    wav = np.random.default_rng(length).normal(size=(2, length)) \
        .astype(np.float32)
    params = _random_params(jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                                           jnp.zeros((2, length))), seed=2)
    ref_logits, ref_fmaps = jax.jit(jd.apply)(params, wav)
    td = disc.HifiGANDiscriminator(disc.DiscriminatorConfig(**kw))
    load_jax_params(td, params)
    with torch.no_grad():
        logits, fmaps = td(torch.from_numpy(wav))
    assert len(logits) == len(ref_logits) == 8
    for a, b in zip(logits, ref_logits):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=FMAP_ATOL)
    for fa, fb in zip(fmaps, ref_fmaps, strict=True):
        for a, b in zip(fa, fb, strict=True):
            b = to_torch_layout(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=FMAP_ATOL)
    convs = {n: m for n, m in td.named_modules()
             if isinstance(m, torch.nn.Conv1d)}
    assert [convs[f"msd_0.Conv_{i}"].groups for i in range(7)] == \
        [1, 4, 16, 16, 16, 16, 1]


def test_stft_and_gan_losses_match_jax():
    rng = np.random.default_rng(0)
    fake, real = (rng.normal(size=(2, 4000)).astype(np.float32) * s
                  for s in (0.1, 0.3))
    fake[0, :500] = 0.0                      # magnitudes under the clip
    got = stft_loss.stft_loss(torch.from_numpy(fake), torch.from_numpy(real))
    ref = jax.jit(jstft.stft_loss)(fake, real)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)
    logits = [rng.normal(size=(2, n)).astype(np.float32) for n in (5, 9, 3)]
    fakes = [rng.normal(size=(2, n)).astype(np.float32) for n in (5, 9, 3)]
    maps = [[rng.normal(size=(2, 3, n)).astype(np.float32)
             for n in (7, 4)] for _ in range(3)]
    maps2 = [[m + 0.1 * rng.normal(size=m.shape).astype(np.float32)
              for m in ms] for ms in maps]

    def t(xs):
        return [torch.from_numpy(x) if isinstance(x, np.ndarray) else t(x)
                for x in xs]

    pairs = [(disc.lsgan_d_loss(t(logits), t(fakes)),
              jdisc.lsgan_d_loss(logits, fakes)),
             (disc.lsgan_g_loss(t(fakes)), jdisc.lsgan_g_loss(fakes)),
             (disc.feature_matching_loss(t(maps), t(maps2)),
              jdisc.feature_matching_loss(maps, maps2))]
    for a, b in pairs:
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def shared():
    """JAX's params, a batch and the ``value_and_grad`` of both groups'
    losses (``_gen_loss``, ``_disc_loss``) in one program."""
    jtask = JaxGANTask(JaxGANConfig(gen=JaxHifiGAN(**GEN),
                                    disc=jdisc.DiscriminatorConfig(**DISC),
                                    segment_frames=16, lambda_stft=1.0))
    params = _random_params(jax.eval_shape(jtask.init_params,
                                           jax.random.PRNGKey(0)), seed=4)
    rng = np.random.default_rng(1)
    batch = {"mels": rng.normal(size=(4, 16, 20)).astype(np.float32),
             "wav": (rng.normal(size=(4, 256)) * 0.1).astype(np.float32),
             "weight": np.ones(4, np.float32)}

    def both(p):
        return tuple(jax.value_and_grad(
            lambda q, f=f: f(q, batch, None), has_aux=True)(p)
            for f in (jtask._gen_loss, jtask._disc_loss))

    out = jax.jit(both)(params)
    res = {"params": params, "batch": batch}
    for name, ((value, metrics), grads) in zip(("gen", "disc"), out):
        res[name] = {"loss": float(value),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": jax.tree.map(np.asarray, grads[name])}
    return res


def port_task(shared=None, **kw):
    cfg = VocoderGANTaskConfig(gen=HifiGANConfig(**GEN),
                               disc=disc.DiscriminatorConfig(**DISC),
                               segment_frames=16, lambda_stft=1.0, **kw)
    return VocoderGANTask(cfg, params=None if shared is None
                          else shared["params"], device="cpu")


@pytest.mark.parametrize("group", ["gen", "disc"])
def test_group_losses_and_grads_match_jax(shared, group):
    """Each group's loss terms within ``LOSS_RTOL`` and the gradients of
    its own parameters within ``GRAD_RTOL`` of each tensor's largest."""
    task = port_task(shared)
    batch = {k: torch.from_numpy(v) for k, v in shared["batch"].items()}
    loss, metrics = task.loss_fns[group](batch, None)
    ref = shared[group]
    assert sorted(metrics) == sorted(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    module = task.modules[group]
    grads = torch.autograd.grad(loss, list(module.parameters()))
    scratch = HifiGANGenerator(task.cfg.gen) if group == "gen" \
        else disc.HifiGANDiscriminator(task.cfg.disc)
    load_jax_params(scratch, ref["grads"])
    sd = scratch.state_dict()
    for (n, _), g in zip(module.named_parameters(), grads, strict=True):
        r = sd[n].numpy()
        assert np.abs(r).max() > 0, n
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_RTOL * np.abs(r).max(),
                                   err_msg=n)


def test_two_trainer_steps_move_both_groups(shared, tmp_path):
    """``disc`` then ``gen`` on each batch: both groups move, the step
    advances once per batch, each group's optimizer twice."""
    task = port_task(shared)
    before = {g: {k: v.clone() for k, v in m.state_dict().items()}
              for g, m in task.modules.items()}
    trainer = Trainer(task, TrainerConfig(
        work_dir=str(tmp_path), log_interval=1, num_sanity_val_steps=0,
        use_tensorboard=False), device="cpu")
    assert trainer.groups == ["disc", "gen"]
    state = trainer.fit(iter([shared["batch"]] * 2), max_updates=2)
    assert state["step"] == 2
    assert trainer.opt["disc"].count == trainer.opt["gen"].count == 2
    for g, m in task.modules.items():
        assert any(not torch.equal(before[g][k], v)
                   for k, v in m.state_dict().items()), g
    with open(tmp_path / "metrics.jsonl") as f:
        tr = [json.loads(line) for line in f]
    assert [line["step"] for line in tr] == [1, 2]
    assert {"d_loss", "g_adv", "g_fm", "g_mel", "g_stft"} <= set(tr[-1])


def test_train_cli_trains_vocoder_gan(tmp_path):
    """``train_cli.main`` with ``configs/vocoder/hifigan.yaml`` narrowed by
    the JAX CLI test's hparams (the CLI's discriminators stay at full
    width, as JAX's): finite metrics of both groups and a checkpoint
    holding both."""
    with RecordWriter(str(tmp_path / "bin" / "train")) as w:
        for r in _tts_records(hop=16):
            w.add(r)
    hp = (f"data.binary_dir={tmp_path / 'bin'}," + CASES["vocoder_gan"][1]
          + ",num_sanity_val_steps=0,log_interval=1,val_check_interval=50,"
          "use_tensorboard=false")
    exp = str(tmp_path / "exp")
    train_cli.main(["--config", os.path.join(REPO, "configs", "vocoder",
                                             "hifigan.yaml"),
                    "--exp_name", exp, "--hparams", hp, "--device", "cpu",
                    "--max_updates", "1"])
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        tr = [json.loads(line) for line in f]
    assert len(tr) == 1 and {"d_loss", "g_adv", "g_fm", "g_mel"} <= set(tr[0])
    assert all(np.isfinite(v) for v in tr[0].values() if isinstance(v, float))
    ck = torch.load(os.path.join(exp, "ckpt", "1.pt"), weights_only=True)
    assert set(ck["params"]) == {"disc", "gen"}
    assert "msd_0.Conv_6.weight" in ck["params"]["disc"]
    cfg = train_cli.load_config(os.path.join(REPO, "configs", "vocoder",
                                             "hifigan.yaml"), overrides=hp)
    batches, val_fn = train_cli.build_loaders(cfg, "vocoder_gan")
    batch = next(batches)
    assert val_fn is None and batch["wav"].shape == (8, 8 * 16)
