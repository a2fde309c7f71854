"""Diffusion schedules and samplers (DDIM, PLMS, DPM-Solver++(2M)).

Counterpart of ``audiogpt_tpu/models/diffusion/samplers.py:28-282``. The
schedule math is the JAX package's numpy, unchanged. The JAX ``lax.scan``
step loops are Python loops here; the per-step scalars are computed in
float32 on the host, as the JAX scan computed them in float32 on the device.
Classifier-free guidance batches the (uncond, cond) pair into one 2N-batch
``eps_fn`` call per step. Inpainting's mask blend, the cosine schedule and
DDPM come with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray

    @classmethod
    def linear(cls, timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.0120) -> "DiffusionSchedule":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                            dtype=np.float64) ** 2
        alphas = 1.0 - betas
        return cls(betas.astype(np.float32),
                   np.cumprod(alphas).astype(np.float32))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    def ddim_steps(self, n_steps: int, eta: float = 0.0):
        """(timesteps, alphas, alphas_prev, sigmas) for a DDIM run
        (ddim.py:27-57 ``make_schedule``)."""
        c = self.num_timesteps // n_steps
        ts = np.asarray(list(range(0, self.num_timesteps, c))) + 1
        ts = np.clip(ts, 0, self.num_timesteps - 1)
        a = self.alphas_cumprod[ts]
        a_prev = np.concatenate([[self.alphas_cumprod[0]], a[:-1]])
        sigmas = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
        return (ts.astype(np.int32), a.astype(np.float32),
                a_prev.astype(np.float32), sigmas.astype(np.float32))


def _guided(eps_fn: Callable, context: torch.Tensor,
            uncond_context: torch.Tensor | None,
            guidance_scale: float) -> Callable:
    """eps(x, t) with the CFG pair batched into one eps_fn call."""
    use_cfg = guidance_scale != 1.0 and uncond_context is not None
    c2 = torch.cat([uncond_context, context]) if use_cfg else None

    def eps(x: torch.Tensor, t: int) -> torch.Tensor:
        t_vec = torch.full((x.shape[0],), int(t), dtype=torch.int32,
                           device=x.device)
        if not use_cfg:
            return eps_fn(x, t_vec, context)
        e_uc, e_c = eps_fn(torch.cat([x, x]), torch.cat([t_vec, t_vec]),
                           c2).chunk(2)
        return e_uc + guidance_scale * (e_c - e_uc)

    return eps


def ddim_sample(
    eps_fn: Callable,                  # (x, t[B], context) -> eps
    schedule: DiffusionSchedule,
    x_T: torch.Tensor,                 # [B, C, H, W] initial noise
    context: torch.Tensor,             # [B, L, D] conditioning
    uncond_context: torch.Tensor | None,
    n_steps: int = 100,
    guidance_scale: float = 1.0,
) -> torch.Tensor:
    """Deterministic DDIM (η = 0, as every engine calls it) from the
    noisiest step down (ddim.py:118); CFG doubles the batch inside each
    eps_fn call."""
    ts, a, a_prev, _ = schedule.ddim_steps(n_steps, eta=0.0)
    eps = _guided(eps_fn, context, uncond_context, guidance_scale)
    img = x_T
    for t, at, at_prev in zip(ts[::-1], a[::-1], a_prev[::-1]):
        e_t = eps(img, t)
        pred_x0 = (img - np.sqrt(_f32(1.0) - at) * e_t) / np.sqrt(at)
        img = (np.sqrt(at_prev) * pred_x0
               + np.sqrt(np.maximum(_f32(1.0) - at_prev, _f32(0.0))) * e_t)
    return img


def plms_sample(
    eps_fn: Callable,
    schedule: DiffusionSchedule,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: torch.Tensor | None,
    n_steps: int = 100,
    guidance_scale: float = 1.0,
) -> torch.Tensor:
    """PLMS (pseudo linear multi-step, ``plms.py``): Adams-Bashforth over the
    eps history, at most 3 deep."""
    ts, a, a_prev, _ = schedule.ddim_steps(n_steps, eta=0.0)
    eps = _guided(eps_fn, context, uncond_context, guidance_scale)
    img = x_T
    hist: list[torch.Tensor] = []       # most recent first
    for t, at, at_prev in zip(ts[::-1], a[::-1], a_prev[::-1]):
        e_t = eps(img, t)
        if len(hist) == 0:
            e_prime = e_t
        elif len(hist) == 1:
            e_prime = (3 * e_t - hist[0]) / 2
        elif len(hist) == 2:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1]
                       - 9 * hist[2]) / 24
        pred_x0 = (img - np.sqrt(_f32(1.0) - at) * e_prime) / np.sqrt(at)
        img = (np.sqrt(at_prev) * pred_x0
               + np.sqrt(_f32(1.0) - at_prev) * e_prime)
        hist = [e_t] + hist[:2]
    return img


def dpmpp_sample(
    eps_fn: Callable,
    schedule: DiffusionSchedule,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: torch.Tensor | None,
    n_steps: int = 15,
    guidance_scale: float = 1.0,
) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022, multistep data-prediction form).

    Math (VP, λ = log(α/σ), h_i = λ_{i} − λ_{i-1}, r = h_{i-1}/h_i):
      x0_i = (x − σ_i ε_θ)/α_i
      D    = (1 + 1/2r)·x0_i − (1/2r)·x0_{i-1}      (first step: D = x0_i)
      x_{i+1} = (σ_{next}/σ_i)·x − α_next·(e^{−h}−1)·D
    """
    ts, a, a_prev, _ = schedule.ddim_steps(n_steps, eta=0.0)
    eps = _guided(eps_fn, context, uncond_context, guidance_scale)
    img = x_T

    def lam(acum):
        return _f32(0.5) * (np.log(acum) - np.log1p(-acum))

    x0_prev, h_prev = None, _f32(1.0)
    for t, at, at_next in zip(ts[::-1], a[::-1], a_prev[::-1]):
        al, sg = np.sqrt(at), np.sqrt(_f32(1.0) - at)
        al_n, sg_n = np.sqrt(at_next), np.sqrt(_f32(1.0) - at_next)
        h = lam(at_next) - lam(at)
        e_t = eps(img, t)
        x0_hat = (img - sg * e_t) / al
        if x0_prev is None:
            d = x0_hat
        else:
            r = h_prev / h
            c = _f32(1.0) / (_f32(2.0) * r)
            d = (_f32(1.0) + c) * x0_hat - c * x0_prev
        img = (sg_n / sg) * img - (al_n * np.expm1(-h)) * d
        x0_prev, h_prev = x0_hat, h
    return img
