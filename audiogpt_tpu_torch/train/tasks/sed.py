"""Sound-event-detection training (AudioSet tagging).

Counterpart of ``audiogpt_tpu/train/tasks/sed.py`` (the reference trainer,
``audio_detection/audio_infer/pytorch/main.py:377``: clipwise BCE on the
AudioSet labels with mixup). The PANN-SED model (``models/sed/
panns_sed.py``) runs as JAX applies it, with ``train=False``: its
BatchNorms use their running statistics while the gradients flow, so
:class:`SEDTask` keeps the model in eval mode whatever mode it is put in
and a step moves no buffer. The loss is the weighted clipwise BCE, plus
the framewise BCE when a batch carries strong labels.

Mixup draws λ ~ Beta(α, α) and a batch permutation from the task's
generator on the batch's device (:meth:`SEDTask.draws`); ``loss(batch,
draws=)`` takes them from the caller instead, which is how the tests
replay JAX's ``beta`` and ``permutation`` of ``split(rng)``. In a
data-parallel run the permutation is the global batch's (cut to the rank's
rows) and mixes in any rank's clips (``gather_rows``), and the means run
over the global batch, as JAX's step sees the whole sharded batch.

Batch schema: ``wav`` [B, T], ``wav_len`` [B], the multi-hot ``target``
[B, 527], optional ``frame_target`` [B, frames, 527], ``weight`` [B]
(``data/loader.py`` ``collate_tagging``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.sed.panns_sed import SEDConfig, SEDModel
from audiogpt_tpu_torch.parallel.reduce import (gather_rows, global_mean,
                                                global_rows, global_sums,
                                                local_rows)
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

#: Marsaglia–Tsang proposals drawn per gamma sample, all at once so the
#: draw needs no host sync; each is accepted with probability > 0.95 for a
#: shape ≥ 1, so all of them failing is below 1e-20
_GAMMA_PROPOSALS = 16


def _bce(logits_or_probs: torch.Tensor, target: torch.Tensor,
         from_probs: bool = True) -> torch.Tensor:
    """Elementwise binary cross-entropy from probabilities (clipped to
    [1e-7, 1 − 1e-7]) or from logits."""
    if from_probs:
        p = logits_or_probs.clamp(1e-7, 1 - 1e-7)
        return -(target * torch.log(p) + (1 - target) * torch.log1p(-p))
    z = logits_or_probs
    return torch.maximum(z, torch.zeros_like(z)) - z * target \
        + torch.log1p(torch.exp(-z.abs()))


def standard_gamma(alpha: float, n: int, generator: torch.Generator | None,
                   device: torch.device) -> torch.Tensor:
    """``n`` Gamma(α, 1) samples on ``device`` from ``generator``
    (Marsaglia and Tsang; a shape below 1 takes Gamma(α + 1)·U^(1/α))."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = (9.0 * d) ** -0.5
    z = torch.randn(n, _GAMMA_PROPOSALS, generator=generator, device=device)
    u = torch.rand(n, _GAMMA_PROPOSALS, generator=generator, device=device)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    first = ok.int().argmax(-1, keepdim=True)
    g = d * v.gather(1, first)[:, 0]
    if alpha < 1.0:
        g = g * torch.rand(n, generator=generator,
                           device=device) ** (1.0 / alpha)
    return g


class _RunningStatsSED(SEDModel):
    """The SED model that stays in eval mode (JAX's ``train=False``)."""

    def train(self, mode: bool = True) -> "_RunningStatsSED":
        return super().train(False)


@dataclasses.dataclass(frozen=True)
class SEDTaskConfig:
    model: SEDConfig = SEDConfig()
    mixup_alpha: float = 1.0        # main.py mixup augmentation
    lambda_frame: float = 1.0
    optim: OptimConfig = OptimConfig(
        optimizer="adam", lr=1e-3, schedule="constant", beta1=0.9,
        beta2=0.999, clip_grad_norm=1.0)


class SEDTask:
    """One optimized group, ``model``. ``params``: the JAX task's
    ``{"model": {"params", "batch_stats"}}`` tree (numpy leaves) to load;
    ``None`` keeps a seeded random init. ``device=None`` is the card, and
    raises without one."""

    def __init__(self, cfg: SEDTaskConfig, params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: _RunningStatsSED(
            cfg.model)).to(self.device).eval()
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        load_jax_params(self.model, params["model"])

    def draws(self, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator | None) -> dict:
        """Mixup's ``lam`` (a 0-d tensor) and ``perm`` [B] for the batch:
        the global batch's permutation at this rank's rows."""
        wav = batch["wav"]
        g = standard_gamma(self.cfg.mixup_alpha, 2, generator, wav.device)
        perm = torch.randperm(global_rows(wav.shape[0]), generator=generator,
                              device=wav.device)
        return {"lam": g[0] / (g[0] + g[1]), "perm": local_rows(perm)}

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None,
             draws: dict | None = None):
        """→ (total, {clip_bce, frame_bce (with ``frame_target``),
        total_loss})."""
        cfg = self.cfg
        wav = batch["wav"]
        target = batch["target"].float()
        if cfg.mixup_alpha > 0:
            if draws is None:
                draws = self.draws(batch, generator)
            lam, perm = draws["lam"], draws["perm"].long()
            wav = lam * wav + (1 - lam) * gather_rows(wav)[perm]
            target = lam * target + (1 - lam) * gather_rows(target)[perm]
        wav_len = batch.get("wav_len")
        out = self.model(wav, None if wav_len is None else wav_len.long())
        w = batch.get("weight")
        err = _bce(out["clipwise_output"], target)
        if w is not None:
            num, rows = global_sums((err * w[:, None]).sum(), w.sum())
            clip = num / (rows * target.shape[-1]).clamp_min(1.0)
        else:
            clip = global_mean(err)
        metrics = {"clip_bce": clip}
        if "frame_target" in batch and cfg.lambda_frame > 0:
            ft = batch["frame_target"].float()
            fw = out["framewise_output"][:, :ft.shape[1]]
            ferr = _bce(fw, ft)
            if w is not None:
                ferr = ferr * w[:, None, None]
            metrics["frame_bce"] = global_mean(ferr) * cfg.lambda_frame
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
