"""Diffusion schedules and samplers (DDIM, PLMS, DPM-Solver++(2M), DDPM).

Counterpart of ``audiogpt_tpu/models/diffusion/samplers.py:28-327``. The
schedule math is the JAX package's numpy, unchanged. The JAX ``lax.scan``
step loops are Python loops here; the per-step scalars are computed in
float32 on the host, as the JAX scan computed them in float32 on the device.
Classifier-free guidance batches the (uncond, cond) pair into one 2N-batch
``eps_fn`` call per step. DDIM and DPM-Solver++ take inpainting's mask
blend (ddim.py:148-151). DDPM is DiffSinger's ancestral loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

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

    @classmethod
    def cosine(cls, timesteps: int, s: float = 0.008) -> "DiffusionSchedule":
        steps = np.arange(timesteps + 1, dtype=np.float64) / timesteps
        f = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
        acum = f / f[0]
        betas = np.clip(1 - acum[1:] / acum[:-1], 0, 0.999)
        return cls(betas.astype(np.float32),
                   np.cumprod(1 - betas).astype(np.float32))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    def q_sample(self, x0: torch.Tensor, t: int | torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward noising √ᾱ_t·x0 + √(1−ᾱ_t)·noise. An int ``t`` noises
        the batch at one timestep, the scalars in float32 on the host (a
        device gather would need a host-to-device copy, which synchronises
        the stream, at every sampler step); an int tensor ``t`` [B] noises
        each item at its own (training, JAX ``samplers.py:53-58``): ᾱ
        gathered from an f32 table on ``x0``'s device, the roots in f32."""
        if isinstance(t, torch.Tensor):
            a = torch.as_tensor(self.alphas_cumprod, device=x0.device)[
                t.long()].reshape((-1,) + (1,) * (x0.ndim - 1))
            return a.sqrt() * x0 + (1.0 - a).sqrt() * noise
        a = self.alphas_cumprod[t]
        return np.sqrt(a) * x0 + np.sqrt(_f32(1.0) - a) * noise

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


#: the per-step noise of the inpaint blend: a generator to draw it from, or
#: one tensor per step (a replay of another sampler's draws)
Noise = torch.Generator | Sequence[torch.Tensor]


def _inpaint_blend(schedule: DiffusionSchedule, img: torch.Tensor, t: int,
                   i: int, mask: torch.Tensor, x0: torch.Tensor,
                   noise: Noise) -> torch.Tensor:
    """Step ``i`` at timestep ``t``: the known region (mask 1 = keep) is
    replaced by x0 noised to t (ddim.py:148-151)."""
    if isinstance(noise, torch.Generator):
        nz = torch.randn(img.shape, generator=noise, device=img.device,
                         dtype=img.dtype)
    else:
        nz = noise[i]
    return schedule.q_sample(x0, t, nz) * mask + (1.0 - mask) * img


def ddim_sample(
    eps_fn: Callable,                  # (x, t[B], context) -> eps
    schedule: DiffusionSchedule,
    x_T: torch.Tensor,                 # [B, C, H, W] initial noise
    context: torch.Tensor,             # [B, L, D] conditioning
    uncond_context: torch.Tensor | None,
    n_steps: int = 100,
    guidance_scale: float = 1.0,
    mask: torch.Tensor | None = None,  # inpaint: 1 = keep original
    x0: torch.Tensor | None = None,    # inpaint: original latent
    noise: Noise | None = None,        # inpaint: per-step blend noise
) -> torch.Tensor:
    """Deterministic DDIM (η = 0, as every engine calls it) from the
    noisiest step down (ddim.py:118); CFG doubles the batch inside each
    eps_fn call. With ``mask`` and ``x0``, each step first blends in x0
    noised to its timestep, and the result keeps x0 where mask is 1."""
    ts, a, a_prev, _ = schedule.ddim_steps(n_steps, eta=0.0)
    eps = _guided(eps_fn, context, uncond_context, guidance_scale)
    inpaint = mask is not None and x0 is not None
    img = x_T
    for i, (t, at, at_prev) in enumerate(zip(ts[::-1], a[::-1],
                                             a_prev[::-1])):
        if inpaint:
            img = _inpaint_blend(schedule, img, t, i, mask, x0, noise)
        e_t = eps(img, t)
        pred_x0 = (img - np.sqrt(_f32(1.0) - at) * e_t) / np.sqrt(at)
        img = (np.sqrt(at_prev) * pred_x0
               + np.sqrt(np.maximum(_f32(1.0) - at_prev, _f32(0.0))) * e_t)
    if inpaint:
        img = x0 * mask + (1.0 - mask) * img
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
    mask: torch.Tensor | None = None,  # inpaint: 1 = keep original
    x0: torch.Tensor | None = None,    # inpaint: original latent
    noise: Noise | None = None,        # inpaint: per-step blend noise
) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022, multistep data-prediction form),
    with the inpaint blend of :func:`ddim_sample`.

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

    inpaint = mask is not None and x0 is not None
    x0_prev, h_prev = None, _f32(1.0)
    for i, (t, at, at_next) in enumerate(zip(ts[::-1], a[::-1],
                                             a_prev[::-1])):
        if inpaint:
            img = _inpaint_blend(schedule, img, t, i, mask, x0, noise)
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
    if inpaint:
        img = x0 * mask + (1.0 - mask) * img
    return img


def ddpm_sample(
    eps_fn: Callable,                  # (x, t[B], context) -> eps
    schedule: DiffusionSchedule,
    x_start: torch.Tensor,             # the noisiest step's sample
    context: torch.Tensor,
    noise: Noise,
    from_step: int | None = None,
) -> torch.Tensor:
    """Ancestral sampling over all (or the last ``from_step``) timesteps,
    from ``x_start`` down to t = 0 (DiffSinger's shallow-diffusion loop,
    shallow_diffusion_tts.py:160). x0 is clipped to [-1, 1]. Each step
    draws its noise, t = 0 too, where it is multiplied by 0: ``noise`` is a
    generator or one tensor per step, step i at t = t_max − 1 − i."""
    t_max = from_step if from_step is not None else schedule.num_timesteps
    betas, acum = schedule.betas, schedule.alphas_cumprod
    acum_prev = np.concatenate([np.ones(1, np.float32), acum[:-1]])
    post_var = betas * (_f32(1.0) - acum_prev) / (_f32(1.0) - acum)
    post_logvar = np.log(np.maximum(post_var, _f32(1e-20)))
    img = x_start
    for i, t in enumerate(range(t_max - 1, -1, -1)):
        t_vec = torch.full((img.shape[0],), t, dtype=torch.int32,
                           device=img.device)
        e = eps_fn(img, t_vec, context)
        x0 = (img - np.sqrt(_f32(1.0) - acum[t]) * e) / np.sqrt(acum[t])
        x0 = x0.clamp(-1.0, 1.0)
        c_x0 = betas[t] * np.sqrt(acum_prev[t]) / (_f32(1.0) - acum[t])
        c_img = (_f32(1.0) - acum_prev[t]) * np.sqrt(_f32(1.0) - betas[t]) \
            / (_f32(1.0) - acum[t])
        if isinstance(noise, torch.Generator):
            nz = torch.randn(img.shape, generator=noise, device=img.device,
                             dtype=img.dtype)
        else:
            nz = noise[i]
        sigma = _f32(t > 0) * np.exp(_f32(0.5) * post_logvar[t])
        img = c_x0 * x0 + c_img * img + sigma * nz
    return img
