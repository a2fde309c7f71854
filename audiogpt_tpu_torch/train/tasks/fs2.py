"""FastSpeech2 training task.

Counterpart of ``audiogpt_tpu/train/tasks/fs2.py`` (the reference's
``FastSpeech2Task``, ``NeuralSeq/tasks/tts/fs2.py:27``): mel L1 (+ SSIM),
log-domain duration MSE, frame-level f0 L1 + uv BCE (or, with
``pitch_type="cwt"``, the CWT spectrum L1, uv BCE and the utterance's
log-f0 mean and std L1), optional energy, all masked by padding, over the
static-shape batches of ``data/loader.py`` ``collate_tts``. The model runs
its training forward: the ground-truth ``mel2ph``, f0 (normalised) and uv
go in (``models/tts/fastspeech2.py``).

The module is grouped as ``{"model": FastSpeech2}``, the JAX task's param
tree, so :meth:`FS2Task.load_jax_params` maps it straight across. The
token ids must be below ``model.vocab_size``: on the card an id past the
embedding is a device-side assert (JAX's gather clamps it silently), so
``train_cli.build_loaders`` checks the binarized phone set against it.
Every masked mean runs over the global batch (``train/losses.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.models.tts.fastspeech2 import (FastSpeech2,
                                                       FastSpeech2Config,
                                                       norm_f0)
from audiogpt_tpu_torch.parallel.reduce import global_sums
from audiogpt_tpu_torch.train import losses as L
from audiogpt_tpu_torch.train.optim import OptimConfig
from audiogpt_tpu_torch.train.ssim import ssim_loss
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


@dataclasses.dataclass(frozen=True)
class FS2TaskConfig:
    model: FastSpeech2Config = FastSpeech2Config()
    lambda_mel: float = 1.0
    lambda_ssim: float = 1.0        # config_base tts: ssim on by default
    lambda_ph_dur: float = 0.1
    lambda_sent_dur: float = 1.0
    lambda_f0: float = 1.0
    lambda_uv: float = 1.0
    lambda_energy: float = 0.1      # fs2 task add_energy_loss
    optim: OptimConfig = OptimConfig()


class FS2Task:
    """One optimized group, ``model``. ``params``: the JAX task's tree
    (numpy leaves) to load; ``None`` keeps a seeded random init.
    ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: FS2TaskConfig, params: Mapping | None = None,
                 device: str | torch.device | None = None,
                 rng_seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = seeded(rng_seed, lambda: FastSpeech2(cfg.model)).to(
            self.device)
        if params is not None:
            self.load_jax_params(params)

    def load_jax_params(self, params: Mapping) -> None:
        """The JAX task's ``{"model": ...}`` tree (numpy leaves),
        strictly."""
        load_jax_params(self.model, params["model"])

    def _forward(self, batch: Mapping[str, torch.Tensor]):
        """The training forward → (model outputs, mel2ph, f0 normalised,
        uv), with the uniform alignment when the batch has no ``mel2ph``
        and uv = (f0 == 0) when it has no ``uv``."""
        mcfg = self.cfg.model
        f0 = batch.get("f0")
        uv = batch.get("uv")
        if uv is None and f0 is not None:
            uv = (f0 == 0).to(f0.dtype)
        f0n = norm_f0(f0, uv, mcfg) if f0 is not None else None
        mel2ph = batch.get("mel2ph")
        if mel2ph is None:
            # no forced alignment in the corpus → uniform fallback
            mel2ph = L.uniform_mel2ph(batch["txt_lengths"],
                                      batch["mel_lengths"],
                                      batch["mels"].shape[1])
        mel2ph = mel2ph.long()
        spk = batch.get("spk_ids")
        out = self.model(batch["txt_tokens"].long(), mel2ph=mel2ph, f0=f0n,
                         uv=uv, spk_id=spk.long() if mcfg.num_spk > 0
                         and spk is not None else None)
        return out, mel2ph, f0n, uv

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None):
        """→ (total, metrics): ``mel``, ``ssim``, ``pdur``, ``sdur``, the
        pitch terms (``f0``, ``uv``; or ``cwt``, ``uv``, ``f0_mean``,
        ``f0_std``), ``e`` with energy, and ``total_loss``. The loss draws
        nothing: ``generator`` is the trainer's protocol."""
        cfg = self.cfg
        mcfg = cfg.model
        out, mel2ph, f0n, uv = self._forward(batch)
        w = batch.get("weight")
        metrics = {}
        target = batch["mels"]
        mel_mask = L.weights_nonzero_speech(target)
        if w is not None:
            mel_mask = mel_mask * w[:, None]
        metrics["mel"] = L.mel_l1_loss(out["mel_out"], target, w) \
            * cfg.lambda_mel
        if cfg.lambda_ssim > 0:
            metrics["ssim"] = ssim_loss(out["mel_out"], target, mel_mask) \
                * cfg.lambda_ssim
        tokens = batch["txt_tokens"]
        metrics.update(L.dur_loss(
            out["dur"], mel2ph, tokens, w, lambda_ph=cfg.lambda_ph_dur,
            lambda_sent=cfg.lambda_sent_dur))
        if mcfg.use_pitch_embed and mcfg.pitch_type == "cwt" \
                and "cwt_spec" in batch:
            # CWT-domain pitch losses (fs2 task add_pitch_loss 'cwt' branch)
            nonpad = (mel2ph > 0).float()
            if w is not None:
                nonpad = nonpad * w[:, None]
            cwt_pred = out["cwt"][..., :10]
            num, den = global_sums(((cwt_pred - batch["cwt_spec"]).abs()
                                    * nonpad[..., None]).sum(), nonpad.sum())
            metrics["cwt"] = num / (den * 10).clamp_min(1.0) * cfg.lambda_f0
            if mcfg.use_uv and uv is not None:
                metrics["uv"] = L.masked_mean(
                    L.bce_with_logits(out["cwt"][..., -1], uv), nonpad) \
                    * cfg.lambda_uv
            if "f0_mean" in batch:
                rw = w if w is not None else torch.ones_like(out["f0_mean"])
                for key in ("f0_mean", "f0_std"):
                    metrics[key] = L.weighted_mean(
                        (out[key] - batch[key]).abs(), rw) * cfg.lambda_f0
        elif mcfg.use_pitch_embed and f0n is not None:
            metrics.update(L.f0_loss(
                out["pitch_pred"], f0n, uv, mel2ph, w,
                lambda_f0=cfg.lambda_f0, lambda_uv=cfg.lambda_uv,
                use_uv=mcfg.use_uv))
        if mcfg.use_energy_embed and "energy" in batch:
            metrics["e"] = L.energy_loss(out["energy_pred"], batch["energy"],
                                         lambda_energy=cfg.lambda_energy)
        total = sum(metrics.values())
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return total, metrics

    def visualize(self, batch: Mapping[str, torch.Tensor],
                  generator: torch.Generator | None = None) -> dict:
        """The first item's predicted and ground-truth mel over its valid
        frames, ``{"mel_0": (pred, gt)}`` ([n, n_mels] each;
        ``FastSpeech2Task.save_valid_result``)."""
        out, _, _, _ = self._forward({k: v for k, v in batch.items()
                                      if k != "spk_ids"})
        if "mel_lengths" in batch:
            n = int(batch["mel_lengths"][0])
        else:
            n = int((batch["mels"][0].abs().sum(-1) > 0).sum())
        n = max(n, 1)
        return {"mel_0": (out["mel_out"][0, :n], batch["mels"][0, :n])}

    @property
    def modules(self) -> Mapping[str, nn.Module]:
        return {"model": self.model}

    @property
    def loss_fns(self) -> Mapping[str, object]:
        return {"model": self.loss}

    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]:
        return {"model": self.cfg.optim}
