"""The LDM (T2A) training recipe against the JAX package's on the CPU, at the
tiny config of ``tests/test_train.py:514-525``: JAX's parameters (from
``jax.eval_shape``, filled with seeded numpy) loaded into the port, the four
draws of JAX's ``_loss`` replayed, the f32 loss and every UNet gradient
against JAX's ``value_and_grad`` and the ``bf16_compute`` loss (one
compiled program for the module), ``bf16_compute`` with
``unet.use_checkpoint`` against the same task without it, two ``Trainer``
steps, and ``train_cli.main`` on a fixture dataset with a resume."""

import os

import jax
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.diffusion import UNetConfig as JaxUNetConfig
from audiogpt_tpu.models.diffusion import VAEConfig as JaxVAEConfig
from audiogpt_tpu.models.textenc import CLAPTextConfig as JaxCLAPConfig
from audiogpt_tpu.models.textenc.bert import BertConfig as JaxBertConfig
from audiogpt_tpu.train.tasks import LDMTask as JaxLDMTask
from audiogpt_tpu.train.tasks import LDMTaskConfig as JaxLDMTaskConfig
from audiogpt_tpu_torch import train_cli
from audiogpt_tpu_torch.data import RecordWriter
from audiogpt_tpu_torch.import_ckpt import restore_weights
from audiogpt_tpu_torch.models.diffusion import (UNetConfig, UNetModel,
                                                 VAEConfig)
from audiogpt_tpu_torch.models.textenc import BertConfig, CLAPTextConfig
from audiogpt_tpu_torch.train import Trainer, TrainerConfig
from audiogpt_tpu_torch.train.tasks import LDMTask, LDMTaskConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_t2a import _random_params

torch.set_num_threads(2)

UNET = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
            num_heads=4, context_dim=24, in_channels=4)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
           in_channels=1, z_channels=4, resolution=16)
BERT = dict(vocab_size=100, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32)
#: the CFG drop at 0.3, so the replayed draw drops some items and not all
TASK = dict(timesteps=50, cond_drop_prob=0.3, scale_factor=0.18215)
B, LATENT = 8, (8, 8)
#: f32: the loss and the UNet's gradients of a chain of f32 layers (VAE
#: encode, CLAP, the UNet forward and backward), summed in another order;
#: gradients relative to the largest of them
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5
#: bf16_compute: both frameworks round the UNet's weights and activations
#: to bf16 (2^-8 relative each), at other points; on a loss of ≈ 1, the
#: mean of 2048 squared errors
BF16_LOSS_ATOL = 5e-3


def jax_cfg(bf16=False):
    return JaxLDMTaskConfig(
        unet=JaxUNetConfig(use_checkpoint=False, **UNET),
        vae=JaxVAEConfig(**VAE),
        clap=JaxCLAPConfig(bert=JaxBertConfig(**BERT), d_proj=24),
        bf16_compute=bf16, **TASK)


def port_cfg(bf16=False, checkpoint=None):
    # f32 runs the UNet under use_checkpoint (recomputed blocks), bf16
    # without it unless asked
    ckpt = not bf16 if checkpoint is None else checkpoint
    return LDMTaskConfig(
        unet=UNetConfig(use_checkpoint=ckpt, **UNET), vae=VAEConfig(**VAE),
        clap=CLAPTextConfig(bert=BertConfig(**BERT), d_proj=24),
        bf16_compute=bf16, **TASK)


@pytest.fixture(scope="module")
def shared():
    """JAX's params, a batch, the replayed draws, and one compiled JAX
    program: the f32 ``value_and_grad`` of ``_loss`` in the UNet params
    and the ``bf16_compute`` task's loss on the same params."""
    jtask = JaxLDMTask(jax_cfg())
    params = _random_params(jax.eval_shape(jtask.init_params,
                                           jax.random.PRNGKey(0)), seed=5)
    rng = np.random.RandomState(6)
    weight = np.ones(B, np.float32)
    weight[-1] = 0.0                               # a padded row
    batch = {"mels": np.tanh(rng.randn(B, 16, 16, 1)).astype(np.float32),
             "text_ids": rng.randint(1, 100, (B, 6)).astype(np.int32),
             "text_mask": np.ones((B, 6), np.int32), "weight": weight}
    key = jax.random.PRNGKey(3)

    def draw():
        k_t, k_noise, k_drop, k_post = jax.random.split(key, 4)
        shape = (B, *LATENT, 4)
        return {"post": jax.random.normal(k_post, shape),
                "drop": jax.random.bernoulli(k_drop, TASK["cond_drop_prob"],
                                             (B, 1, 1)),
                "t": jax.random.randint(k_t, (B,), 0, TASK["timesteps"]),
                "noise": jax.random.normal(k_noise, shape)}

    def loss(unet_p):
        return jtask._loss({**params, "unet": unet_p}, batch, key)[0]

    # the bf16_compute loss and the draws of ``key`` ride in the same
    # program
    jtask_bf16 = JaxLDMTask(jax_cfg(bf16=True))

    def both(unet_p):
        return (jax.value_and_grad(loss)(unet_p),
                jtask_bf16._loss({**params, "unet": unet_p}, batch, key)[0],
                draw())

    (value, grads), bf16_loss, draws = jax.jit(both)(params["unet"])
    assert 0 < int(draws["drop"].sum()) < B
    port_draws = {
        "post": torch.from_numpy(np.asarray(draws["post"])
                                 .transpose(0, 3, 1, 2).copy()),
        "noise": torch.from_numpy(np.asarray(draws["noise"])
                                  .transpose(0, 3, 1, 2).copy()),
        "drop": torch.from_numpy(np.array(draws["drop"])[:, 0, 0]),
        "t": torch.from_numpy(np.asarray(draws["t"])).long()}
    return {"params": params, "batch": batch, "key": key,
            "draws": port_draws, "loss": float(value),
            "bf16_loss": float(bf16_loss),
            "grads": jax.tree.map(np.asarray, grads)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_and_unet_grads_match_jax(shared):
    """The f32 loss and every UNet gradient on JAX's weights and replayed
    draws; JAX's gradient tree goes through ``load_jax_params`` into a
    scratch UNet, so the layouts match by name."""
    task = LDMTask(port_cfg(), params=shared["params"], device="cpu")
    loss, metrics = task.loss(torch_batch(shared["batch"]),
                              draws=shared["draws"])
    assert float(metrics["diff"]) == float(loss.detach())
    np.testing.assert_allclose(float(loss), shared["loss"], rtol=LOSS_RTOL)
    names = [n for n, _ in task.unet.named_parameters()]
    grads = torch.autograd.grad(loss, list(task.unet.parameters()))
    ref = UNetModel(UNetConfig(**UNET))
    load_jax_params(ref, shared["grads"])
    ref = ref.state_dict()
    assert sorted(ref) == sorted(names)
    scale = max(float(ref[n].abs().max()) for n in names)
    for n, g in zip(names, grads):
        assert float(ref[n].abs().max()) > 0, n
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=n)


def test_bf16_compute_loss_matches_jax(shared):
    """``bf16_compute``: the UNet in bf16 on f32 masters, in both
    packages; the loss within the bf16 bound, and every UNet parameter
    gets an f32 gradient through the cast."""
    ref = shared["bf16_loss"]
    task = LDMTask(port_cfg(bf16=True), params=shared["params"],
                   device="cpu")
    loss, _ = task.loss(torch_batch(shared["batch"]), draws=shared["draws"])
    assert abs(float(loss) - float(ref)) <= BF16_LOSS_ATOL
    assert abs(float(loss) - shared["loss"]) <= BF16_LOSS_ATOL
    grads = torch.autograd.grad(loss, list(task.unet.parameters()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def test_bf16_compute_with_use_checkpoint_equals_without(shared):
    """``bf16_compute`` with ``unet.use_checkpoint`` (JAX: ``nn.remat``
    under the cast): each block's recompute in the backward runs on the
    bf16 parameters of its forward, so the loss equals the run without
    checkpointing within ``BF16_LOSS_ATOL`` and every UNet gradient within
    one bf16 step (2^-8) of the largest; the middle attention block runs
    twice a step with checkpointing (the recompute), once without."""
    runs = {}
    for ckpt in (False, True):
        task = LDMTask(port_cfg(bf16=True, checkpoint=ckpt),
                       params=shared["params"], device="cpu")
        calls, block = [], task.unet.mid_attn
        forward = block.forward
        block.forward = lambda *a: calls.append(1) or forward(*a)
        loss, _ = task.loss(torch_batch(shared["batch"]),
                            draws=shared["draws"])
        grads = torch.autograd.grad(loss, list(task.unet.parameters()))
        runs[ckpt] = float(loss), grads, len(calls)
    (loss, grads, calls), (loss_c, grads_c, calls_c) = runs[False], runs[True]
    assert (calls, calls_c) == (1, 2)
    assert abs(loss_c - loss) <= BF16_LOSS_ATOL
    assert abs(loss_c - shared["bf16_loss"]) <= BF16_LOSS_ATOL
    scale = max(float(g.abs().max()) for g in grads)
    for g, g_c in zip(grads, grads_c):
        assert g_c.dtype == torch.float32
        np.testing.assert_allclose(g_c.numpy(), g.numpy(), rtol=0,
                                   atol=2 ** -8 * scale)


def test_two_trainer_steps_move_only_the_unet(shared, tmp_path):
    task = LDMTask(port_cfg(), params=shared["params"], device="cpu")
    unet0 = {k: v.clone() for k, v in task.unet.state_dict().items()}
    frozen0 = {k: v.clone()
               for k, v in task.modules["frozen"].state_dict().items()}
    trainer = Trainer(task, TrainerConfig(
        work_dir=str(tmp_path), log_interval=1, num_sanity_val_steps=0,
        use_tensorboard=False), device="cpu")
    state = trainer.fit(iter([shared["batch"]] * 2), max_updates=2)
    assert state["step"] == 2 and set(state["params"]) == {"unet"}
    assert set(state["opt"]) == set(state["ema"]) == {"unet"}
    assert any(not torch.equal(unet0[k], v)
               for k, v in task.unet.state_dict().items())
    assert all(torch.equal(frozen0[k], v)
               for k, v in task.modules["frozen"].state_dict().items())


def test_train_cli_trains_and_resumes(tmp_path, capsys):
    """``train_cli.main`` on a fixture dataset (the repository's
    ``ldm.yaml`` narrowed by ``--hparams``) writes the config, the metrics
    and checkpoints; a second call resumes from the last one, and a third
    at that step exports the weights (``--export``)."""
    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("valid", 4)):
        with RecordWriter(str(tmp_path / "bin" / split)) as w:
            for _ in range(n):
                w.add({"mel": rng.random((20, 16), dtype=np.float32),
                       "text_ids": rng.integers(1, 100, 5).astype(np.int32)})
    hp = ",".join([
        *(f"model.unet.{k}={list(v) if isinstance(v, tuple) else v}"
          for k, v in UNET.items()),
        *(f"model.vae.{k}={list(v) if isinstance(v, tuple) else v}"
          for k, v in VAE.items()),
        *(f"model.clap.bert.{k}={v}" for k, v in BERT.items()),
        "model.clap.d_proj=24", "model.timesteps=50",
        "model.bf16_compute=false", f"data.binary_dir={tmp_path / 'bin'}",
        "data.width=16", "data.text_len=8", "batch_size=4",
        "val_check_interval=2", "num_sanity_val_steps=1", "log_interval=1",
        "use_tensorboard=false"])
    exp = str(tmp_path / "exp")
    argv = ["--config", os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "t2a", "ldm.yaml"),
            "--exp_name", exp, "--hparams", hp, "--device", "cpu"]
    train_cli.main(argv + ["--max_updates", "3"])
    assert os.path.exists(os.path.join(exp, "config.yaml"))
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == [
        "2.json", "2.pt", "3.json", "3.pt"]
    train_cli.main(argv + ["--max_updates", "4"])
    assert "resumed from step 3" in capsys.readouterr().out
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        lines = [line for line in f if '"tr"' in line]
    assert len(lines) == 4
    # at step 4 already: no step more, the weights exported (the UNet's
    # EMA shadows where the recipe keeps them, else its params)
    train_cli.main(argv + ["--max_updates", "4", "--export",
                           str(tmp_path / "out")])
    exported = restore_weights(str(tmp_path / "out"))
    ck = torch.load(os.path.join(exp, "ckpt", "4.pt"), weights_only=True)
    assert set(exported) == {"unet"}
    for name, t in (ck["ema"].get("unet") or ck["params"]["unet"]).items():
        assert torch.equal(exported["unet"][name], t), name
    with pytest.raises(ValueError, match="unknown task"):
        train_cli.build_task(train_cli.load_config(argv[1],
                                                   overrides="task=nope"))
