"""Adversarial TTS training: the reference's ``ps_adv`` recipe and its
FastSpeech2 counterpart.

Counterpart of ``audiogpt_tpu/train/tasks/tts_adv.py`` (the reference's
``NeuralSeq/tasks/tts/ps_adv.py`` with the multi-window mel critic of
``modules/syntaspeech/multi_window_disc.py``): a generator trained with its
recipe's reconstruction losses plus an LSGAN term from a critic that
scores random 32-, 64- and 128-frame crops of the mel (three stride-2 3×3
conv stacks and a linear validity each, summed over the windows). Groups
``disc`` then ``model``: the trainer runs them in that order on each
batch and takes each group's gradient with respect to its own parameters
only, so the critic is frozen in the ``model`` step; in the ``disc`` step
the generator runs under ``no_grad``, as JAX's ``stop_gradient``.

The crops follow JAX, quirks included (``ROADMAP.md`` §C): every window's
start is drawn below ``max(min(mel_lengths) − win, 0)`` (at least 1), the
batch's shortest length, so the zero-length rows that ``collate_tts`` pads
a batch with put every crop at frame 0; the start is clamped to
``T − win`` as ``dynamic_slice`` clamps it, and the LSGAN means run over
the padded rows too; in a data-parallel run the shortest length and the
means are the global batch's. One draw of each window's start per step,
shared by
the generator's ε: both groups' steps seed the trainer's generator alike
and draw ε then the starts, so they see the same crops, as JAX's one key
a step gives. A start is drawn on the device (a uniform scaled by the
bound), so no draw waits on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.ops.conv import pad_same
from audiogpt_tpu_torch.parallel.reduce import gather_rows, global_mean
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.train.tasks.fs2 import FS2Task, FS2TaskConfig
from audiogpt_tpu_torch.train.tasks.portaspeech import (PortaSpeechTask,
                                                        PortaSpeechTaskConfig)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


class SingleWindowDisc(nn.Module):
    """A mel crop [B, 1, win, M] → validity [B, 1]: three 3×3 stride-2
    SAME convs (flax's padding, the odd one after), each with a leaky ReLU
    (0.2) and the first two with a LayerNorm over the channels (ε = 1e-6),
    then a dense on the features flattened in flax's (H, W, C) order."""

    def __init__(self, win: int, n_mels: int, hidden: int = 128):
        super().__init__()
        h, w = win, n_mels
        for i in range(3):
            self.add_module(f"conv{i}", nn.Conv2d(1 if i == 0 else hidden,
                                                  hidden, 3, stride=2))
            if i < 2:
                self.add_module(f"norm{i}", nn.LayerNorm(hidden, eps=1e-6))
            h, w = -(-h // 2), -(-w // 2)
        self.adv_layer = nn.Linear(h * w * hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"conv{i}")(pad_same(x, 3, 2, dims=2))
            x = F.leaky_relu(x, 0.2)
            if i < 2:
                x = getattr(self, f"norm{i}")(x.permute(0, 2, 3, 1)
                                              ).permute(0, 3, 1, 2)
        return self.adv_layer(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class MultiWindowDiscriminator(nn.Module):
    """The sum of the single-window validities over one random crop per
    window (``multi_window_disc.py:46``)."""

    def __init__(self, n_mels: int, time_lengths: tuple = (32, 64, 128),
                 hidden: int = 128):
        super().__init__()
        self.time_lengths = tuple(time_lengths)
        for win in self.time_lengths:
            self.add_module(f"win{win}", SingleWindowDisc(win, n_mels, hidden))

    def draw_starts(self, mel_len: torch.Tensor,
                    generator: torch.Generator | None) -> torch.Tensor:
        """Each window's start [n_windows] (long, on the device), uniform
        below ``max(min(mel_len) − win, 0)`` or 1, the minimum over the
        global batch: JAX's ``randint(0, max(max_start, 1))``, before its
        clamp."""
        wins = torch.tensor(self.time_lengths, device=mel_len.device)
        bound = (gather_rows(mel_len).min() - wins).clamp_min(1)
        u = torch.rand(len(wins), generator=generator, device=mel_len.device,
                       dtype=torch.float64)
        return (u * bound).floor().long()

    def forward(self, mel: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M], ``starts`` [n_windows] (:meth:`draw_starts`, or
        JAX's replayed) → the summed validity [B, 1]."""
        t = mel.shape[1]
        validity = 0.0
        for i, win in enumerate(self.time_lengths):
            if t < win:
                raise ValueError(f"{t} frames, shorter than the {win}-frame "
                                 f"window")
            start = starts[i].clamp_max(t - win)
            idx = start + torch.arange(win, device=mel.device)
            crop = mel.index_select(1, idx)
            validity = validity + getattr(self, f"win{win}")(crop[:, None])
        return validity


def lsgan_g(v: torch.Tensor) -> torch.Tensor:
    return global_mean((v - 1.0) ** 2)


def lsgan_d(v_real: torch.Tensor, v_fake: torch.Tensor) -> torch.Tensor:
    return global_mean((v_real - 1.0) ** 2) + global_mean(v_fake ** 2)


#: the critic's AdamW (ps_adv.py's disc optimizer)
OPTIM_DISC = OptimConfig(optimizer="adamw", lr=2e-4, schedule="constant",
                         beta1=0.5, beta2=0.999, clip_grad_norm=1.0)


class _AdvBase:
    """What both adversarial recipes share: the critic, the two losses and
    the groups. A subclass gives ``model`` (the generator),
    ``_gen_losses(batch, draws)``, ``_mel(batch, draws)`` and
    ``draws(batch, generator)``."""

    def _build_disc(self, n_mels, windows, hidden, rng_seed):
        self.disc = seeded(rng_seed + 1, lambda: MultiWindowDiscriminator(
            n_mels, windows, hidden)).to(self.device)

    def model_loss(self, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   draws: dict | None = None):
        """→ (total, metrics): the generator's recipe terms plus ``adv``,
        the LSGAN term on its mel, and ``total_loss``."""
        draws = draws if draws is not None else self.draws(batch, generator)
        total, metrics, mel_p = self._gen_losses(batch, draws)
        v = self.disc(mel_p, draws["starts"])
        metrics["adv"] = lsgan_g(v) * self.cfg.lambda_adv
        total = total + metrics["adv"]
        metrics["total_loss"] = total
        return total, {k: v.detach() for k, v in metrics.items()}

    def disc_loss(self, batch: Mapping[str, torch.Tensor],
                  generator: torch.Generator | None = None,
                  draws: dict | None = None):
        """→ (loss, {d_loss}) on the generator's mel (``no_grad``) and the
        target, with the same crops."""
        draws = draws if draws is not None else self.draws(batch, generator)
        with torch.no_grad():
            mel_p = self._mel(batch, draws)
        starts = draws["starts"]
        loss = lsgan_d(self.disc(batch["mels"], starts),
                       self.disc(mel_p, starts))
        return loss, {"d_loss": loss.detach()}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"disc": self.disc, "model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        # disc first, then the generator: its step sees the updated critic
        return {"disc": self.disc_loss, "model": self.model_loss}


@dataclasses.dataclass(frozen=True)
class AdvTTSTaskConfig:
    fs2: FS2TaskConfig = FS2TaskConfig()
    disc_windows: tuple = (32, 64, 128)
    disc_hidden: int = 128
    lambda_adv: float = 0.05            # ps_adv lambda_mel_adv
    optim_disc: OptimConfig = OPTIM_DISC


class AdvTTSTask(_AdvBase):
    """FastSpeech2 with the critic. As JAX's ``_gen_mel``, the mel the
    critic sees comes from a second forward fed the batch's f0 and uv as
    they are (not normalised, as the recipe's own forward feeds them) and
    no speaker: the port copies that (``ROADMAP.md`` §C). ``params``: the
    JAX task's ``{"model", "disc"}`` tree."""

    def __init__(self, cfg: AdvTTSTaskConfig, params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fs2_task = FS2Task(cfg.fs2, device=self.device,
                                rng_seed=rng_seed)
        self.model = self.fs2_task.model
        self._build_disc(cfg.fs2.model.n_mels, cfg.disc_windows,
                         cfg.disc_hidden, rng_seed)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        self.fs2_task.load_jax_params(params)
        load_jax_params(self.disc, params["disc"])

    def draws(self, batch, generator) -> dict:
        return {"starts": self.disc.draw_starts(batch["mel_lengths"],
                                                generator)}

    def _mel(self, batch, draws) -> torch.Tensor:
        return self.model(batch["txt_tokens"].long(),
                        mel2ph=batch["mel2ph"].long(), f0=batch.get("f0"),
                        uv=batch.get("uv"))["mel_out"]

    def _gen_losses(self, batch, draws):
        total, metrics = self.fs2_task.loss(batch)
        return total, dict(metrics), self._mel(batch, draws)

    def val_loss_fn(self, batch, generator=None):
        return self.fs2_task.loss(batch)

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"disc": self.cfg.optim_disc, "model": self.cfg.fs2.optim}


@dataclasses.dataclass(frozen=True)
class PortaSpeechAdvTaskConfig:
    ps: PortaSpeechTaskConfig = PortaSpeechTaskConfig()
    disc_windows: tuple = (32, 64, 128)
    disc_hidden: int = 128
    lambda_adv: float = 0.05            # ps_adv lambda_mel_adv
    optim_disc: OptimConfig = OPTIM_DISC


class PortaSpeechAdvTask(_AdvBase):
    """``ps_adv`` (``NeuralSeq/tasks/tts/ps_adv.py``): the PortaSpeech
    FVAE generator and the critic; with ``ps.model.use_graph`` the
    ``synta_adv`` recipe. ``draws`` replays ``{"eps", "starts"}``.
    ``params``: the JAX task's ``{"model", "disc"}`` tree."""

    def __init__(self, cfg: PortaSpeechAdvTaskConfig,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ps_task = PortaSpeechTask(cfg.ps, device=self.device,
                                       rng_seed=rng_seed)
        self.model = self.ps_task.model
        self._build_disc(cfg.ps.model.n_mels, cfg.disc_windows,
                         cfg.disc_hidden, rng_seed)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        self.ps_task.load_jax_params(params)
        load_jax_params(self.disc, params["disc"])

    def draws(self, batch, generator) -> dict:
        """ε, then the windows' starts: both groups draw in this order."""
        eps = self.ps_task.draws(batch, generator)
        return {"eps": eps,
                "starts": self.disc.draw_starts(batch["mel_lengths"],
                                                generator)}

    def _mel(self, batch, draws) -> torch.Tensor:
        return self._gen_losses(batch, draws)[2]

    def _gen_losses(self, batch, draws):
        total, metrics, out = self.ps_task.forward_and_losses(batch,
                                                              draws["eps"])
        return total, metrics, out["mel_out"]

    def val_loss_fn(self, batch, generator=None):
        return self.ps_task.loss(batch, generator)

    def visualize(self, batch, generator=None) -> dict:
        return self.ps_task.visualize(batch, generator)

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"disc": self.cfg.optim_disc, "model": self.cfg.ps.optim}
