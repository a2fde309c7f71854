"""The port's ``Trainer`` on scalar toy tasks on the CPU, against closed-form
expectations: accumulation equals the big batch, the LitEma ramp (2/11 at
the first update) and EMA seeding on resume, the NaN guard (zeros that
still step), kill and resume, preemption, validation on the EMA params, a
two-group task's step count, and the ``metrics.jsonl`` keys against the
JAX trainer's on the same toy."""

import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from audiogpt_tpu.train import OptimConfig as JaxOptimConfig
from audiogpt_tpu.train import Trainer as JaxTrainer
from audiogpt_tpu.train import TrainerConfig as JaxTrainerConfig
from audiogpt_tpu_torch.train import OptimConfig, Trainer, TrainerConfig

torch.set_num_threads(2)

#: Adam on one scalar, constant lr, no clip
ADAM = dict(optimizer="adam", lr=0.1, schedule="constant",
            clip_grad_norm=0.0)


class Scalar(nn.Module):
    def __init__(self, value: float):
        super().__init__()
        self.w = nn.Parameter(torch.tensor([value]))


class ToyTask:
    """loss = Σ weight·(w·x − y)² / Σ weight per group: one scalar ``w``
    per group; the groups' losses are independent."""

    def __init__(self, optim: dict, groups=("w",), value: float = 1.0):
        self._modules = {g: Scalar(value) for g in groups}
        self._optim = {g: OptimConfig(**optim) for g in groups}

    def _loss(self, group):
        def loss(batch, generator):
            w = self._modules[group].w
            err = batch["weight"] * (w * batch["x"] - batch["y"]) ** 2
            total = err.sum() / batch["weight"].sum()
            return total, {"loss": total.detach()}
        return loss

    @property
    def modules(self):
        return self._modules

    @property
    def loss_fns(self):
        return {g: self._loss(g) for g in self._modules}

    @property
    def optim_cfgs(self):
        return self._optim


def toy_batch(n=8, seed=0, nan=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float32)
    if nan:
        x[0] = np.nan
    return {"x": x, "y": (2.0 * x).astype(np.float32),
            "weight": np.ones(n, np.float32)}


def repeat(*batches):
    while True:
        yield from batches


def make(tmp_path, task, **cfg):
    base = dict(work_dir=str(tmp_path), val_check_interval=100,
                log_interval=1, num_sanity_val_steps=0,
                use_tensorboard=False)
    base.update(cfg)
    return Trainer(task, TrainerConfig(**base), device="cpu")


def w_of(trainer, group="w"):
    return float(trainer.task.modules[group].w.detach())


def read_log(tmp_path):
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_accumulation_equals_the_big_batch(tmp_path):
    """Two half batches with ``accumulate_steps=2`` give the params that
    one step on the whole batch gives."""
    big = toy_batch(8)
    halves = [{k: v[:4] for k, v in big.items()},
              {k: v[4:] for k, v in big.items()}]
    acc = make(tmp_path / "acc", ToyTask({**ADAM, "accumulate_steps": 2}))
    acc.fit(iter(halves), max_updates=2)
    one = make(tmp_path / "one", ToyTask(ADAM))
    one.fit(iter([big]), max_updates=1)
    assert w_of(acc) == pytest.approx(w_of(one), abs=1e-7)
    assert acc.opt["w"].count == one.opt["w"].count == 1


def test_ema_ramp_and_resume_without_ema(tmp_path):
    """LitEma: e ← e − (1 − d)(e − p) with d = min(decay, (n + 1)/(10 + n))
    and n the 1-based update count (2/11 first); a checkpoint written
    without shadows seeds them from its params on restore."""
    trainer = make(tmp_path / "ema", ToyTask({**ADAM, "ema_decay": 0.5}))
    e = w_of(trainer)
    batches = repeat(toy_batch())
    for n in (1, 2, 3):
        trainer.fit(batches, max_updates=n)
        d = min(0.5, (n + 1) / (10 + n))
        e = e - (1 - d) * (e - w_of(trainer))
        assert float(trainer.ema["w"][0]) == pytest.approx(e, abs=1e-6)
    assert (1 + 1) / (10 + 1) == pytest.approx(2 / 11)
    plain = make(tmp_path / "plain", ToyTask(ADAM))
    plain.fit(repeat(toy_batch()), max_updates=2)
    assert plain.store.saved_ema_groups(2) == set()
    resumed = make(tmp_path / "plain", ToyTask({**ADAM, "ema_decay": 0.5},
                                               value=-3.0))
    resumed.restore_or_init()
    assert resumed.step == 2 and w_of(resumed) == w_of(plain)
    assert float(resumed.ema["w"][0]) == w_of(plain)


def test_nan_guard_counts_and_still_steps(tmp_path):
    """A non-finite loss zeroes the step's gradients, is counted in
    ``nonfinite``, and Adam still steps: the params move by momentum, by
    exactly the zero-gradient update."""
    trainer = make(tmp_path, ToyTask(ADAM))
    trainer.fit(iter([toy_batch()]), max_updates=1)
    opt = trainer.opt["w"]
    mu, nu, w1 = float(opt.mu[0][0]), float(opt.nu[0][0]), w_of(trainer)
    trainer.fit(iter([toy_batch(nan=True)]), max_updates=2)
    b1, b2 = 0.9, 0.98
    mu, nu = b1 * mu, b2 * nu
    step = 0.1 * (mu / (1 - b1 ** 2)) / (np.sqrt(nu / (1 - b2 ** 2)) + 1e-8)
    assert w_of(trainer) != w1
    assert w_of(trainer) == pytest.approx(w1 - step, abs=1e-6)
    tr = [line for line in read_log(tmp_path) if line["prefix"] == "tr"]
    assert [line["nonfinite"] for line in tr] == [0.0, 1.0]
    assert tr[1]["grad_norm"] == 0.0 and tr[0]["grad_norm"] > 0


def test_kill_and_resume_continue_at_the_same_step(tmp_path):
    """A run stopped at step 3 (its final checkpoint) and restarted to 5
    ends where an uninterrupted run of 5 ends, logging steps 4 and 5."""
    batches = [toy_batch(seed=s) for s in range(5)]
    whole = make(tmp_path / "whole", ToyTask(ADAM))
    whole.fit(iter(batches), max_updates=5)
    first = make(tmp_path / "cut", ToyTask(ADAM))
    first.fit(iter(batches[:3]), max_updates=3)
    second = make(tmp_path / "cut", ToyTask(ADAM, value=7.0))
    second.fit(iter(batches[3:]), max_updates=5)
    assert second.step == 5 and w_of(second) == pytest.approx(w_of(whole),
                                                              abs=1e-7)
    steps = [line["step"] for line in read_log(tmp_path / "cut")
             if line["prefix"] == "tr"]
    assert steps == [1, 2, 3, 4, 5]
    assert second.store.all_steps() == [3, 5]


def test_preemption_saves(tmp_path, capsys):
    """SIGTERM during a run stops it after the current step and writes a
    checkpoint there; the previous handler comes back."""
    def batches():
        for i in range(10):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield toy_batch(seed=i)

    before = signal.getsignal(signal.SIGTERM)
    trainer = make(tmp_path, ToyTask(ADAM))
    trainer.fit(batches(), max_updates=10)
    assert trainer.step == 2 and trainer.store.latest_step() == 2
    assert "graceful stop at step 2" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) == before


def test_validation_runs_on_the_ema_params(tmp_path):
    """The validation loss is the loss at the EMA shadow, and the live
    params come back after it."""
    trainer = make(tmp_path, ToyTask({**ADAM, "ema_decay": 0.9}))
    batch = toy_batch()
    trainer.fit(repeat(batch), max_updates=4)
    live, ema = w_of(trainer), float(trainer.ema["w"][0])
    assert abs(live - ema) > 1e-3
    got = trainer.validate([batch])["total_loss"]
    x, y = batch["x"].astype(np.float64), batch["y"]
    assert got == pytest.approx(float(np.mean((ema * x - y) ** 2)),
                                rel=1e-5)
    assert w_of(trainer) == live


def test_two_groups_advance_the_step_once(tmp_path):
    trainer = make(tmp_path, ToyTask(ADAM, groups=("a", "b")))
    trainer.fit(repeat(toy_batch()), max_updates=3)
    assert trainer.step == 3
    assert trainer.opt["a"].count == trainer.opt["b"].count == 3
    assert w_of(trainer, "a") == w_of(trainer, "b") != 1.0
    ck = trainer.store.restore()
    assert ck["step"] == 3 and set(ck["params"]) == {"a", "b"}


class JaxToyTask:
    """The toy of :class:`ToyTask` as a JAX task (one group)."""

    def init_params(self, rng):
        return {"w": jnp.ones((1,))}

    @property
    def loss_fns(self):
        def loss(params, batch, rng):
            err = batch["weight"] * (params["w"][0] * batch["x"]
                                     - batch["y"]) ** 2
            total = err.sum() / batch["weight"].sum()
            return total, {"loss": total}
        return {"w": loss}

    @property
    def optim_cfgs(self):
        return {"w": JaxOptimConfig(**ADAM)}


def test_metrics_keys_match_jax(tmp_path):
    """The same prefixes and keys in ``metrics.jsonl`` as the JAX trainer
    writes for the same toy, config and steps (no ``mfu`` on the CPU)."""
    cfg = dict(val_check_interval=2, log_interval=1, num_sanity_val_steps=1,
               use_tensorboard=False)
    batch = toy_batch()
    jt = JaxTrainer(JaxToyTask(), JaxTrainerConfig(
        work_dir=str(tmp_path / "jax"), **cfg))
    jt.fit(repeat(batch), lambda: [batch], max_updates=2)
    pt = make(tmp_path / "port", ToyTask(ADAM), **cfg)
    pt.fit(repeat(batch), lambda: [batch], max_updates=2)

    def keys(path):
        return [(line["prefix"], line["step"], sorted(line))
                for line in read_log(path)]

    assert keys(tmp_path / "port") == keys(tmp_path / "jax")
    assert jt.store.all_steps() == pt.store.all_steps()
