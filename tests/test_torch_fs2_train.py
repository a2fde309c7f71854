"""The FastSpeech2 training recipe against the JAX package's on the CPU: the
masked losses and the SSIM map, ``FS2Task``'s loss terms and the gradient
of every parameter against JAX's ``value_and_grad`` on one batch (JAX's
parameters from ``jax.eval_shape`` filled with seeded numpy, loaded into
the port; one compiled program for each pitch type, ``frame`` and
``cwt``), the validation figure, and ``train_cli`` training and resuming
``fs2`` on a fixture dataset."""

import functools
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from audiogpt_tpu.models.tts.fastspeech2 import \
    FastSpeech2Config as JaxFS2Config
from audiogpt_tpu.train import losses as jlosses
from audiogpt_tpu.train import ssim as jssim
from audiogpt_tpu.train.tasks import FS2Task as JaxFS2Task
from audiogpt_tpu.train.tasks import FS2TaskConfig as JaxFS2TaskConfig
from audiogpt_tpu_torch import train_cli
from audiogpt_tpu_torch.data import RecordWriter
from audiogpt_tpu_torch.models.tts.fastspeech2 import (FastSpeech2,
                                                       FastSpeech2Config)
from audiogpt_tpu_torch.train import Trainer, TrainerConfig, losses, ssim
from audiogpt_tpu_torch.train.tasks import FS2Task, FS2TaskConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_t2a import _random_params
from test_train_cli import CASES, _tts_records

torch.set_num_threads(2)

MODEL = dict(vocab_size=30, hidden_size=16, enc_layers=1, dec_layers=1,
             num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
             dur_predictor_layers=1, predictor_layers=2, predictor_hidden=8,
             max_frames=64)
B, T, F = 4, 12, 64
#: f32: the loss terms of one forward (sums in another order) relative to
#: each term, and every gradient against its tensor's largest
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
#: the SSIM map in f32: σ² = blur(x²) − μ² cancels on inputs shifted by +6
#: (x² ≈ 36), so each framework's map lies ≈ 2.5e-5 from the float64 map
SSIM_ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fs2_batch(seed=1):
    """A padded batch: a short item, a dummy row of weight 0, unvoiced
    frames, and the CWT targets."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(3, 30, (B, T)).astype(np.int32)
    tok[1, 9:] = 0
    tok[3, 5:] = 0
    lens = (tok > 0).sum(1)
    mlen = np.array([60, 40, 64, 20])
    mel2ph = np.zeros((B, F), np.int32)
    for b in range(B):
        mel2ph[b, :mlen[b]] = np.minimum(
            np.arange(mlen[b]) * lens[b] // mlen[b] + 1, lens[b])
    valid = (mel2ph > 0)
    f0 = rng.uniform(100, 300, (B, F)) * (rng.random((B, F)) > 0.2) * valid
    w = np.ones(B, np.float32)
    w[3] = 0.0
    return {"txt_tokens": tok, "txt_lengths": lens.astype(np.int32),
            "mels": (rng.normal(size=(B, F, 80)) * valid[..., None])
            .astype(np.float32),
            "mel_lengths": mlen.astype(np.int32), "mel2ph": mel2ph,
            "f0": f0.astype(np.float32), "weight": w,
            "energy": (rng.random((B, F)) * valid).astype(np.float32),
            "cwt_spec": rng.normal(size=(B, F, 10)).astype(np.float32),
            "f0_mean": (rng.normal(size=B) + 5.0).astype(np.float32),
            "f0_std": rng.random(B).astype(np.float32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_reference(pitch):
    """JAX's params and its ``value_and_grad`` of ``_loss`` in the model
    params on one batch, for one pitch type (built once per module)."""
    jtask = JaxFS2Task(JaxFS2TaskConfig(model=JaxFS2Config(
        pitch_type=pitch, **MODEL)))
    params = _random_params(jax.eval_shape(jtask.init_params,
                                           jax.random.PRNGKey(0)), seed=5)
    batch = fs2_batch()

    def loss(p):
        return jtask._loss({"model": p}, batch, None)

    (value, metrics), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params["model"])
    return {"pitch": pitch, "params": params, "batch": batch, "jtask": jtask,
            "loss": float(value),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree.map(np.asarray, grads)}


def port_task(shared, **kw):
    cfg = FS2TaskConfig(model=FastSpeech2Config(pitch_type=shared["pitch"],
                                                **MODEL), **kw)
    return FS2Task(cfg, params=shared["params"], device="cpu")


def test_losses_and_ssim_match_jax():
    """Each helper of ``train/losses.py`` and the SSIM map and loss on the
    same padded inputs (JAX's side in one jitted program)."""
    batch = fs2_batch(2)
    rng = np.random.default_rng(3)
    pred = rng.normal(size=batch["mels"].shape).astype(np.float32)
    dur_pred = rng.normal(size=(B, T)).astype(np.float32)
    mask = (np.abs(batch["mels"]).sum(-1) > 0).astype(np.float32)
    f0n = (batch["f0"] - 200.0) / 60.0
    uv = (batch["f0"] == 0).astype(np.float32)

    def helpers(L, S, pred, dur_pred, mask, f0n, uv, b):
        w = b["weight"]
        out = {"ssim_map": S.ssim(pred + 6.0, b["mels"] + 6.0),
               "ssim": S.ssim_loss(pred, b["mels"], mask),
               "mel": L.mel_l1_loss(pred, b["mels"], w),
               "e": L.energy_loss(pred[..., 0], b["energy"]),
               "uniform": L.uniform_mel2ph(b["txt_lengths"],
                                           b["mel_lengths"], F),
               "dur": L.mel2ph_to_dur(b["mel2ph"], T)}
        for rw in (None, w):
            d = L.dur_loss(dur_pred, b["mel2ph"], b["txt_tokens"], rw)
            out.update({f"{k}_{rw is None}": v for k, v in d.items()})
        for use_uv in (True, False):
            d = L.f0_loss(pred[..., :2], f0n, uv, b["mel2ph"], w,
                          use_uv=use_uv)
            out.update({f"{k}_{use_uv}": v for k, v in d.items()})
        return out

    args = (pred, dur_pred, mask, f0n, uv, batch)
    ref = jax.jit(lambda *a: helpers(jlosses, jssim, *a))(*args)
    got = helpers(losses, ssim, *(torch.from_numpy(a) for a in args[:-1]),
                  torch_batch(batch))
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose(got.pop("ssim_map").numpy(),
                               np.asarray(ref["ssim_map"]), rtol=0,
                               atol=SSIM_ATOL)
    for k in ("uniform", "dur"):
        np.testing.assert_array_equal(got.pop(k).numpy(), np.asarray(ref[k]))
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("pitch", ["frame", "cwt"])
def test_fs2_loss_terms_and_grads_match_jax(pitch):
    """Every loss term within ``LOSS_RTOL``; JAX's gradient tree goes
    through ``load_jax_params`` into a scratch model, so the layouts match
    by name, and each gradient is within ``GRAD_RTOL`` of its tensor's
    largest."""
    shared = jax_reference(pitch)
    task = port_task(shared)
    loss, metrics = task.loss(torch_batch(shared["batch"]))
    assert sorted(metrics) == sorted(shared["metrics"])
    terms = {"frame": {"f0", "uv"},
             "cwt": {"cwt", "uv", "f0_mean", "f0_std"}}[shared["pitch"]]
    assert terms <= set(metrics)
    for k, v in shared["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    names = [n for n, _ in task.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(task.model.parameters()),
                                allow_unused=True)
    ref = FastSpeech2(task.cfg.model)
    load_jax_params(ref, shared["grads"])
    ref = ref.state_dict()
    assert sorted(ref) == sorted(names)
    for n, g in zip(names, grads):
        r = ref[n].numpy()
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_RTOL * np.abs(r).max(),
                                   err_msg=n)


def test_visualize_arrays_and_the_validation_png(tmp_path):
    """``visualize`` gives JAX's arrays (the first item's valid frames);
    the trainer's validation writes them as a PNG of the stated layout."""
    shared = jax_reference("frame")
    task = port_task(shared)
    batch = shared["batch"]
    with torch.no_grad():
        figs = task.visualize(torch_batch(batch))
    jtask = shared["jtask"]
    # JAX's visualize with its model's apply jitted (op by op it takes
    # seconds)
    jvis = JaxFS2Task(jtask.cfg)
    jvis.model = types.SimpleNamespace(apply=jax.jit(
        jtask.model.apply, static_argnames=("infer",)))
    jfigs = jvis.visualize(shared["params"], batch, None)
    assert list(figs) == list(jfigs) == ["mel_0"]
    for a, b in zip(figs["mel_0"], jfigs["mel_0"]):
        assert a.shape == (60, 80)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    trainer = Trainer(task, TrainerConfig(work_dir=str(tmp_path),
                                          use_tensorboard=False),
                      device="cpu")
    avgs = trainer.validate([batch])
    assert np.isfinite(avgs["total_loss"])
    png = tmp_path / "figures" / "mel_0_0.png"
    with Image.open(png) as img:
        assert img.size == (4 * (60 + 2 + 60), 4 * 80 + 20)


def test_train_cli_trains_and_resumes_fs2(tmp_path, capsys):
    """``train_cli.main`` with ``configs/tts/fs2.yaml`` narrowed by the JAX
    CLI test's hparams, on the device the caller names: the config, finite
    metrics, checkpoints, a validation figure; a second call resumes."""
    bin_dir = tmp_path / "bin"
    recs = _tts_records()
    for split, rows in (("train", recs), ("valid", recs[:2])):
        with RecordWriter(str(bin_dir / split)) as w:
            for r in rows:
                w.add(r)
    hp = (f"data.binary_dir={bin_dir}," + CASES["fs2"][1]
          + ",num_sanity_val_steps=1,log_interval=1,val_check_interval=2,"
          "use_tensorboard=false")
    exp = str(tmp_path / "exp")
    argv = ["--config", os.path.join(REPO, "configs", "tts", "fs2.yaml"),
            "--exp_name", exp, "--hparams", hp, "--device", "cpu"]
    train_cli.main(argv + ["--max_updates", "2"])
    assert os.path.exists(os.path.join(exp, "config.yaml"))
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["2.json",
                                                             "2.pt"]
    assert sorted(os.listdir(os.path.join(exp, "figures"))) == [
        "mel_0_0.png", "mel_0_2.png"]
    train_cli.main(argv + ["--max_updates", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    tr = [line for line in lines if line["prefix"] == "tr"]
    assert [line["step"] for line in tr] == [1, 2, 3]
    for line in tr:
        # the hparams set lambda_ssim to 0: no ssim term
        assert {"mel", "pdur", "sdur", "f0", "uv"} <= set(line)
        assert "ssim" not in line
        assert all(np.isfinite(v) for v in line.values()
                   if isinstance(v, float))


def test_phone_set_past_the_vocab_is_refused(tmp_path):
    """An id past ``model.vocab_size`` would be a device-side assert on the
    card: ``build_loaders`` compares the binarized phone set with it."""
    with RecordWriter(str(tmp_path / "train")) as w:
        for r in _tts_records(2):
            w.add(r)
    with open(tmp_path / "phone_set.json", "w") as f:
        json.dump([f"p{i}" for i in range(40)], f)
    cfg = train_cli.load_config(
        os.path.join(REPO, "configs", "tts", "fs2.yaml"),
        overrides=f"data.binary_dir={tmp_path},model.vocab_size=30")
    with pytest.raises(ValueError, match="vocab_size"):
        train_cli.build_loaders(cfg, "fs2")
    cfg = train_cli.load_config(       # the default vocab: 100 ids
        os.path.join(REPO, "configs", "tts", "fs2.yaml"),
        overrides=f"data.binary_dir={tmp_path}")
    batches, val_fn = train_cli.build_loaders(cfg, "fs2")
    assert val_fn is None and next(batches)["txt_tokens"].shape[0] == 8
