"""DiffSinger (shallow-diffusion SVS) training task.

Counterpart of ``audiogpt_tpu/train/tasks/diffusion.py`` (the reference's
``DiffSingerTask``, ``NeuralSeq/tasks/svs/diffsinger_task.py:30``, over
``GaussianDiffusion.p_losses``,
``modules/diff/shallow_diffusion_tts.py:233``): t ~ U[0, K_step), the
normalised ground-truth mel noised to step t, the WaveNet denoiser's ε
under the FS2-MIDI conditioner's ``decoder_inp``, L1 on ε over the frames
with a phone; FS2's duration loss (and, with ``use_pitch_embed``, its f0
and uv losses) trains the conditioner jointly. A corpus without
``mel2ph`` gets the uniform alignment, as ``fs2`` does.

The loss's two draws, t [B] and ε [B, F, M], come from the trainer's
generator or are replayed (``draws=``), so a test holds the loss to JAX's
``randint`` and ``normal`` of its keys. The module is grouped as
``{"model": DiffSinger}``, the JAX task's tree (``DiffSingerTask.init_params``
inits through ``__call__``, the SVS engine's tree). The token ids must be
below ``model.fs2.vocab_size`` (``train_cli.check_vocabs``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.svs.diffsinger import (DiffSinger,
                                                      DiffSingerConfig)
from audiogpt_tpu_torch.models.tts.fastspeech2 import norm_f0
from audiogpt_tpu_torch.parallel.reduce import (global_rows, global_sums,
                                                local_rows)
from audiogpt_tpu_torch.train import losses as L
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

#: the batch's score fields, passed to FS2-MIDI as they are
_SCORE = ("pitch_midi", "midi_dur", "is_slur")


@dataclasses.dataclass(frozen=True)
class DiffSingerTaskConfig:
    model: DiffSingerConfig = DiffSingerConfig()
    lambda_diff: float = 1.0
    lambda_ph_dur: float = 0.1
    lambda_sent_dur: float = 1.0
    lambda_f0: float = 1.0
    lambda_uv: float = 1.0
    optim: OptimConfig = OptimConfig()


class DiffSingerTask:
    """One optimized group, ``model``. ``params``: the JAX task's tree
    (numpy leaves) to load; ``None`` keeps a seeded random init.
    ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: DiffSingerTaskConfig,
                 params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: DiffSinger(cfg.model)).to(
            self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"model": ...}`` tree (numpy leaves),
        strictly."""
        load_jax_params(self.model, params["model"])

    def draws(self, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator | None) -> dict:
        """``t`` [B] uniform in [0, K_step) and ``noise`` [B, F, M] for
        ``batch``'s mels (drawn for the global batch, cut to this rank's
        rows)."""
        mels = batch["mels"]
        b, f = global_rows(mels.shape[0]), mels.shape[1]
        t = torch.randint(0, self.cfg.model.K_step, (b,),
                          generator=generator, device=mels.device)
        noise = torch.randn((b, f, self.cfg.model.net.mel_bins),
                            generator=generator, device=mels.device)
        return {"t": local_rows(t), "noise": local_rows(noise)}

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None,
             draws: Mapping[str, torch.Tensor] | None = None):
        """→ (total, metrics): ``diff``, ``pdur``, ``sdur``, with the pitch
        embedding ``f0`` and ``uv``, and ``total_loss``. ``draws`` (``t``,
        ``noise``) replaces the draws from ``generator``."""
        cfg = self.cfg
        mcfg = cfg.model
        fs2_kw = {k: batch[k].long() if k != "midi_dur" else batch[k]
                  for k in _SCORE if k in batch}
        f0 = batch.get("f0")
        uv = batch.get("uv")
        if uv is None and f0 is not None:
            uv = (f0 == 0).to(f0.dtype)
        if f0 is not None:
            fs2_kw["f0"] = norm_f0(f0, uv, mcfg.fs2)
            fs2_kw["uv"] = uv
        mel2ph = batch.get("mel2ph")
        if mel2ph is None:
            # an unaligned corpus → the uniform fallback, as FS2Task's
            mel2ph = L.uniform_mel2ph(batch["txt_lengths"],
                                      batch["mel_lengths"],
                                      batch["mels"].shape[1])
        mel2ph = mel2ph.long()
        tokens = batch["txt_tokens"].long()
        cond, x0, aux = self.model.train_loss_inputs_full(
            tokens, mel2ph, batch["mels"], **fs2_kw)
        if draws is None:
            draws = self.draws(batch, generator)
        noise = draws["noise"]
        x_t = self.model.schedule.q_sample(x0, draws["t"], noise)
        eps = self.model.denoiser(x_t, draws["t"], cond)

        w = batch.get("weight")
        frame_mask = (mel2ph > 0).float()
        if w is not None:
            frame_mask = frame_mask * w[:, None]
        num, den = global_sums(
            ((eps - noise).abs() * frame_mask[..., None]).sum(),
            frame_mask.sum())
        metrics = {"diff": num / (den * x0.shape[-1]).clamp_min(1.0)
                   * cfg.lambda_diff}
        metrics.update(L.dur_loss(
            aux["dur"], mel2ph, tokens, w, lambda_ph=cfg.lambda_ph_dur,
            lambda_sent=cfg.lambda_sent_dur))
        if mcfg.fs2.use_pitch_embed and f0 is not None:
            metrics.update(L.f0_loss(
                aux["pitch_pred"], fs2_kw["f0"], uv, mel2ph, w,
                lambda_f0=cfg.lambda_f0, lambda_uv=cfg.lambda_uv,
                use_uv=mcfg.fs2.use_uv))
        total = sum(metrics.values())
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return total, metrics

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        return {"model": self.loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"model": self.cfg.optim}
