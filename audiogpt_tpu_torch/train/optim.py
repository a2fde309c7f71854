"""Optimizers and learning-rate schedules with optax's semantics.

Counterpart of ``audiogpt_tpu/train/optim.py``, which chains optax
transformations. The update here is written out over ``torch._foreach_*``
so that it is optax's, step for step, where ``torch.optim`` differs:

* global-norm clipping is ``optax.clip_by_global_norm``: the gradients are
  scaled by ``max_norm / norm`` only when ``norm >= max_norm`` (not
  ``clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``);
* Adam is ``optax.scale_by_adam``: ε outside the root of the bias-corrected
  second moment, the corrections ``1 - β**count`` in f32;
* AdamW adds the decoupled decay to the update before the learning rate,
  ``u + wd·p`` (``optax.add_decayed_weights``), so the step is
  ``-lr·(u + wd·p)``;
* the learning rate of an update is the schedule at the count of updates
  applied before it (``optax.scale_by_learning_rate``);
* accumulation is ``optax.MultiSteps``: the running mean of k gradients,
  then one update of the inner chain (clip, Adam) on that mean; the
  updates in between are zero and leave the inner state as it was.

The schedules compute in float32, as the JAX ones do on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

_f32 = np.float32
Schedule = Callable[[int], float]


def warmup_rsqrt_schedule(lr: float = 2.0, warmup_steps: int = 8000,
                          hidden_size: int = 256) -> Schedule:
    """lr * d^-0.5 * min(step*warmup^-1.5, step^-0.5) (Transformer/NoamLR —
    the reference's RSQRTSchedule)."""
    scale = _f32(lr * hidden_size ** -0.5)
    w = _f32(warmup_steps ** -1.5)

    def schedule(step: int) -> float:
        s = _f32(step) + _f32(1.0)
        return float(scale * min(s * w, s ** _f32(-0.5)))

    return schedule


def exponential_schedule(lr: float, every: int, decay: float) -> Schedule:
    """``optax.exponential_decay(lr, every, decay, staircase=True)``: lr ·
    decay^⌊step / every⌋."""
    def schedule(step: int) -> float:
        p = np.floor(_f32(step) / _f32(every))
        return float(_f32(lr) * _f32(decay) ** _f32(p))

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"          # 'adam' | 'adamw'
    lr: float = 2.0
    schedule: str = "rsqrt"          # 'rsqrt' | 'constant' | 'exponential'
    warmup_steps: int = 8000
    hidden_size: int = 256
    beta1: float = 0.9
    beta2: float = 0.98
    weight_decay: float = 0.0
    clip_grad_norm: float = 1.0      # 0 disables
    accumulate_steps: int = 1
    lr_decay: float = 0.999          # exponential schedule (GAN)
    lr_decay_every: int = 1000
    #: weight EMA (reference LitEma, ldm/modules/ema.py via ddpm.py:43
    #: ``use_ema=True``): 0 disables; the trainer keeps the shadows.
    #: ``ema_warmup`` reproduces LitEma's num_updates ramp
    #: ``min(decay, (1 + n) / (10 + n))``.
    ema_decay: float = 0.0
    ema_warmup: bool = True


def make_schedule(cfg: OptimConfig) -> Schedule:
    if cfg.schedule == "rsqrt":
        return warmup_rsqrt_schedule(cfg.lr, cfg.warmup_steps, cfg.hidden_size)
    if cfg.schedule == "exponential":
        return exponential_schedule(cfg.lr, cfg.lr_decay_every, cfg.lr_decay)
    return lambda step: float(_f32(cfg.lr))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√Σ‖t‖² over the tensors (``optax.global_norm``), f32, on their
    device; no host synchronisation."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """``make_optimizer(cfg)``'s chain applied in place to ``params``.

    ``step(grads)`` takes one gradient per parameter (zeros, not ``None``,
    where a parameter got none) and consumes them. The state is optax's:
    Adam's ``mu``, ``nu`` and ``count``, and under accumulation the running
    mean ``acc`` and ``mini_step``. Every decision is made from host
    counters, so a step queues its kernels without synchronising."""

    def __init__(self, cfg: OptimConfig, params: Sequence[torch.Tensor]):
        if cfg.optimizer not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.params = list(params)
        self.schedule = make_schedule(cfg)
        self.count = 0                  # updates applied (the inner count)
        self.mini_step = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.accumulate_steps > 1 else None)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        k = self.cfg.accumulate_steps
        if self.acc is not None:
            # Welford mean of the mini-steps' gradients (MultiSteps)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            emit = self.mini_step == k - 1
            self.mini_step = (self.mini_step + 1) % k
            if not emit:
                return
            grads = self.acc
        self._update(grads)
        if self.acc is not None:
            self.acc = [torch.zeros_like(p) for p in self.params]

    def _update(self, grads: list[torch.Tensor]) -> None:
        cfg = self.cfg
        if cfg.clip_grad_norm and cfg.clip_grad_norm > 0:
            norm = global_norm(grads)
            # t unchanged below the threshold, t·(max/norm) at or above it
            scale = torch.where(norm < cfg.clip_grad_norm,
                                torch.ones_like(norm),
                                cfg.clip_grad_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        b1, b2, eps = cfg.beta1, cfg.beta2, 1e-8
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(_f32(1.0) - _f32(b1) ** _f32(self.count))
        bc2 = float(_f32(1.0) - _f32(b2) ** _f32(self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        if cfg.optimizer == "adamw" and cfg.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": list(self.mu), "nu": list(self.nu),
                "acc": None if self.acc is None else list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = int(state["count"]), \
            int(state["mini_step"])
        for dst, src in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                         (self.acc, state["acc"])):
            if dst is None:
                continue
            if src is None or len(src) != len(dst):
                raise ValueError("optimizer state does not fit the params")
            for d, s in zip(dst, src):
                d.copy_(s)


def make_optimizer(cfg: OptimConfig,
                   params: Sequence[torch.Tensor]) -> Optimizer:
    """The optimizer of ``cfg`` over ``params`` (optax's
    ``MultiSteps(chain(clip_by_global_norm, adam[w]))``)."""
    return Optimizer(cfg, params)
