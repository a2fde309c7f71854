"""DiffSinger: a FastSpeech2-MIDI conditioner and a WaveNet denoiser that
samples the mel by shallow diffusion.

Counterpart of ``audiogpt_tpu/models/svs/diffsinger.py:34-243`` (the
reference's ``GaussianDiffusion``,
``NeuralSeq/modules/diff/shallow_diffusion_tts.py:71``, with ``DiffNet``,
``modules/diff/net.py:81``, and ``FastSpeech2MIDI``,
``modules/diffsinger_midi/fs2.py:46``). The JAX ``lax.scan`` samplers are
Python loops: :func:`plms_interval_sample` (the app's default, PLMS with a
fixed step interval) and ``models/diffusion/samplers.py`` ``ddpm_sample``.
Tensors are frame-major ``[B, T, C]`` at the module boundary, as in JAX;
the denoiser runs its convs in ``[B, C, T]``. Submodules carry the flax
scope names (``fs2``, ``denoiser.res_0_dilated``, ``output_projection``),
each flax ``nn.Conv`` a bare ``torch.nn.Conv1d``.

Draws are explicit: a ``torch.Generator``, or replayed tensors (``x_T``,
and for DDPM one tensor per step), so a test can replay JAX's keys.
Training (``train/tasks/diffusion.py``) runs FS2's training forward
through :meth:`DiffSinger.train_loss_inputs_full`, then the denoiser.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.diffusion.samplers import (
    DiffusionSchedule,
    Noise,
    ddpm_sample,
)
from audiogpt_tpu_torch.models.tts.fastspeech2 import (
    FastSpeech2,
    FastSpeech2Config,
)

_f32 = np.float32

#: a sampler's randomness: a generator, or the replayed draws
#: ``(x_T [B, T, M], per-step noise)`` (the noise only read by DDPM)
Draws = torch.Generator | tuple[torch.Tensor, Noise | None]


@dataclasses.dataclass(frozen=True)
class DiffNetConfig:
    mel_bins: int = 80
    encoder_hidden: int = 256
    residual_layers: int = 20
    residual_channels: int = 256
    dilation_cycle_length: int = 4


@dataclasses.dataclass(frozen=True)
class DiffSingerConfig:
    fs2: FastSpeech2Config = FastSpeech2Config(use_midi=True, rel_pos=True,
                                               use_pitch_embed=False)
    net: DiffNetConfig = DiffNetConfig()
    timesteps: int = 1000
    K_step: int = 1000
    max_beta: float = 0.02
    schedule_type: str = "linear"
    spec_min: Sequence[float] = (-6.0,) * 80
    spec_max: Sequence[float] = (1.5,) * 80
    gaussian_start: bool = True

    def schedule(self) -> DiffusionSchedule:
        if self.schedule_type == "linear":
            betas = np.linspace(1e-4, self.max_beta, self.timesteps)
            return DiffusionSchedule(
                betas.astype(np.float32),
                np.cumprod(1.0 - betas).astype(np.float32))
        return DiffusionSchedule.cosine(self.timesteps)


class DiffNet(nn.Module):
    """spec [B, T, M], t [B], cond [B, T, H] → eps [B, T, M]."""

    def __init__(self, cfg: DiffNetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.residual_channels
        self.input_projection = nn.Conv1d(cfg.mel_bins, c, 1)
        self.mlp_0 = nn.Linear(c, 4 * c)
        self.mlp_2 = nn.Linear(4 * c, c)
        for i in range(cfg.residual_layers):
            d = 2 ** (i % cfg.dilation_cycle_length)
            self.add_module(f"res_{i}_diff", nn.Linear(c, c))
            self.add_module(f"res_{i}_dilated",
                            nn.Conv1d(c, 2 * c, 3, padding=d, dilation=d))
            self.add_module(f"res_{i}_cond",
                            nn.Conv1d(cfg.encoder_hidden, 2 * c, 1))
            self.add_module(f"res_{i}_out", nn.Conv1d(c, 2 * c, 1))
        self.skip_projection = nn.Conv1d(c, c, 1)
        # zero-initialised, as the JAX module (diffsinger.py:108)
        self.output_projection = nn.Conv1d(c, cfg.mel_bins, 1)
        nn.init.zeros_(self.output_projection.weight)
        nn.init.zeros_(self.output_projection.bias)

    def forward(self, spec: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        c = cfg.residual_channels
        x = torch.relu(self.input_projection(spec.transpose(1, 2)))
        cond = cond.transpose(1, 2)
        # SinusoidalPosEmb (net.py:32): the sin half first, over half − 1
        half = c // 2
        freqs = torch.exp(torch.arange(half, device=spec.device)
                          * -(math.log(10000.0) / (half - 1)))
        emb = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], -1)
        emb = self.mlp_2(F.mish(self.mlp_0(emb)))
        skips = None
        for i in range(cfg.residual_layers):
            y = x + getattr(self, f"res_{i}_diff")(emb)[:, :, None]
            y = getattr(self, f"res_{i}_dilated")(y) \
                + getattr(self, f"res_{i}_cond")(cond)
            gate, filt = y.chunk(2, dim=1)
            y = getattr(self, f"res_{i}_out")(torch.sigmoid(gate)
                                              * torch.tanh(filt))
            residual, skip = y.chunk(2, dim=1)
            x = (x + residual) / math.sqrt(2.0)
            skips = skip if skips is None else skips + skip
        x = torch.relu(self.skip_projection(
            skips / math.sqrt(cfg.residual_layers)))
        return self.output_projection(x).transpose(1, 2)


def plms_interval_sample(eps_fn: Callable, schedule: DiffusionSchedule,
                         x: torch.Tensor, cond: torch.Tensor, t_max: int,
                         interval: int) -> torch.Tensor:
    """DiffSinger's PLMS with a fixed step interval (``p_sample_plms``,
    shallow_diffusion_tts.py:169): timesteps ``t_max − interval, …, 0``
    (``arange(0, t_max, interval)`` reversed). The first step is a
    second-order warm-up with one extra eps eval; later steps are
    Adams-Bashforth over the eps history (newest first, at most 3 deep).
    ᾱ_prev is 1 where t < interval."""
    acum = schedule.alphas_cumprod

    def x_pred(x, noise_t, t):
        a_t = acum[t]
        a_prev = _f32(1.0) if t < interval else acum[max(t - interval, 0)]
        a_t_sq, a_prev_sq = np.sqrt(a_t), np.sqrt(a_prev)
        d1 = a_t_sq * (a_t_sq + a_prev_sq)
        d2 = a_t_sq * (np.sqrt((_f32(1.0) - a_prev) * a_t)
                       + np.sqrt((_f32(1.0) - a_t) * a_prev))
        return x + (a_prev - a_t) * (x / d1 - noise_t / d2)

    def eps(x, t):
        t_vec = torch.full((x.shape[0],), int(t), dtype=torch.int32,
                           device=x.device)
        return eps_fn(x, t_vec, cond)

    hist: list[torch.Tensor] = []           # newest first
    for t in np.arange(0, t_max, interval)[::-1]:
        t = int(t)
        e = eps(x, t)
        if not hist:
            e2 = eps(x_pred(x, e, t), max(t - interval, 0))
            e_prime = (e + e2) / 2.0
        elif len(hist) == 1:
            e_prime = (3 * e - hist[0]) / 2
        elif len(hist) == 2:
            e_prime = (23 * e - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e - 59 * hist[0] + 37 * hist[1]
                       - 9 * hist[2]) / 24
        x = x_pred(x, e_prime, t)
        hist = [e] + hist[:2]
    return x


class DiffSinger(nn.Module):
    """The conditioner (``fs2``) and the denoiser under one module, so one
    parameter tree serves both."""

    def __init__(self, cfg: DiffSingerConfig):
        super().__init__()
        self.cfg = cfg
        self.fs2 = FastSpeech2(cfg.fs2)
        # the condition is FS2's decoder input: flax infers its width
        self.denoiser = DiffNet(dataclasses.replace(
            cfg.net, encoder_hidden=cfg.fs2.hidden_size))
        self.schedule = cfg.schedule()
        self.register_buffer("spec_min", torch.tensor(cfg.spec_min),
                             persistent=False)
        self.register_buffer("spec_max", torch.tensor(cfg.spec_max),
                             persistent=False)

    def norm_spec(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.spec_min, self.spec_max
        return (x - lo) / (hi - lo) * 2.0 - 1.0

    def denorm_spec(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.spec_min, self.spec_max
        return (x + 1.0) / 2.0 * (hi - lo) + lo

    def conditioner(self, tokens: torch.Tensor,
                    pitch_midi: torch.Tensor | None = None,
                    midi_dur: torch.Tensor | None = None,
                    is_slur: torch.Tensor | None = None,
                    mel2ph: torch.Tensor | None = None) -> dict:
        """FS2-MIDI inference: ``decoder_inp`` [B, F, H] is the denoiser's
        condition, ``mel_out`` the FS2 mel, ``mel2ph`` the alignment."""
        return self.fs2(tokens, mel2ph=mel2ph, pitch_midi=pitch_midi,
                        midi_dur=midi_dur, is_slur=is_slur)

    def train_loss_inputs_full(self, tokens: torch.Tensor,
                               mel2ph: torch.Tensor, ref_mels: torch.Tensor,
                               **kw) -> tuple[torch.Tensor, torch.Tensor,
                                              dict]:
        """FS2's training forward on the ground-truth ``mel2ph`` (``kw``:
        ``f0`` normalised, ``uv``, ``pitch_midi``, ``midi_dur``,
        ``is_slur``) → (cond = ``decoder_inp`` [B, F, H], x0 = the
        normalised ``ref_mels``, the FS2 output dict for the duration and
        pitch losses; the reference trains the conditioner jointly,
        ``diffsinger_task.py:30``)."""
        ret = self.fs2(tokens, mel2ph=mel2ph, **kw)
        return ret["decoder_inp"], self.norm_spec(ref_mels), ret

    def sample(self, ret: dict, draws: Draws,
               pndm_speedup: int | None = 10) -> torch.Tensor:
        """The conditioner's output → the denormalised mel [B, F, M],
        zero where ``mel2ph`` is 0. PLMS with step ``pndm_speedup`` when
        it is above 1, else DDPM over ``K_step`` steps."""
        cfg = self.cfg
        cond = ret["decoder_inp"]
        shape = (cond.shape[0], cond.shape[1], cfg.net.mel_bins)
        if isinstance(draws, torch.Generator):
            x = torch.randn(shape, generator=draws, device=cond.device)
            noise = draws
        else:
            x, noise = draws
        if not cfg.gaussian_start:
            x = self.schedule.q_sample(self.norm_spec(ret["mel_out"]),
                                       cfg.K_step - 1, x)
        if pndm_speedup and pndm_speedup > 1:
            x = plms_interval_sample(self.denoiser, self.schedule, x, cond,
                                     cfg.K_step, pndm_speedup)
        else:
            x = ddpm_sample(self.denoiser, self.schedule, x, cond, noise,
                            from_step=cfg.K_step)
        return self.denorm_spec(x) * (ret["mel2ph"] > 0)[..., None]

    def forward(self, tokens: torch.Tensor,
                pitch_midi: torch.Tensor | None = None,
                midi_dur: torch.Tensor | None = None,
                is_slur: torch.Tensor | None = None,
                draws: Draws | None = None,
                pndm_speedup: int | None = 10,
                mel2ph: torch.Tensor | None = None) -> dict:
        """Score → dict of ``mel_out`` (sampled), ``fs2_mel``, ``mel2ph``
        and ``f0_denorm`` (None without the pitch embedding). ``draws``
        defaults to a generator seeded with 0."""
        if draws is None:
            draws = torch.Generator(tokens.device).manual_seed(0)
        ret = self.conditioner(tokens, pitch_midi, midi_dur, is_slur, mel2ph)
        return {"mel_out": self.sample(ret, draws, pndm_speedup),
                "fs2_mel": ret["mel_out"], "mel2ph": ret["mel2ph"],
                "f0_denorm": ret.get("f0_denorm")}
