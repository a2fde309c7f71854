"""Vocoder engine: mel → wav, static-shape bucketed.

Counterpart of ``audiogpt_tpu/engines/vocoder.py:29-146`` for the BigVGAN
generator, with its bf16 mode. HiFi-GAN, PWG and MelGAN come with later
slices.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from audiogpt_tpu_torch.engines.base import (
    Bucketer,
    resolve_device,
    run_copy,
)
from audiogpt_tpu_torch.models.vocoder.bigvgan import (
    BigVGANConfig,
    BigVGANGenerator,
)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048)


class VocoderEngine:
    name = "vocoder"

    def __init__(self, kind: str = "bigvgan", cfg: BigVGANConfig | None = None,
                 params: Any = None, buckets=DEFAULT_BUCKETS,
                 rng_seed: int = 0, bf16: bool = False,
                 device: str | torch.device | None = None):
        """``params``: a JAX parameter tree as numpy arrays (loaded with
        :func:`load_jax_params`); ``None`` keeps a seeded random init.
        ``device=None`` is the card, and raises without one.

        ``bf16``: the JAX engine's throughput mode (its ``bf16``): the
        generator is cast to bf16 once (the snake log-α/β too), the mel goes
        in as bf16 and the wav comes out as f32, so every AMP activation
        takes ``snake_aa``'s bf16 entry. ``model`` keeps the f32 parameters;
        :meth:`load_state_dict` loads into it and casts again."""
        if kind != "bigvgan":
            raise ValueError(f"vocoder kind {kind!r} is not ported yet")
        self.kind = kind
        self.device = resolve_device(device)
        self.cfg = cfg or BigVGANConfig()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.model = BigVGANGenerator(self.cfg)
        if params is not None:
            load_jax_params(self.model, params)
        self.model.to(self.device).eval()
        self.bf16 = bf16
        self._run = run_copy(self.model, bf16)
        self.bucketer = Bucketer(buckets)

    def load_state_dict(self, state: dict) -> None:
        """Load f32 parameters (a ``model.state_dict()``), strictly."""
        self.model.load_state_dict(state)
        self._run = run_copy(self.model, self.bf16)

    @property
    def hop_size(self) -> int:
        return self.cfg.hop_size

    @torch.inference_mode()
    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, n_mels, frames] on the engine's device → f32 wav
        [B, frames · hop], run at the frames' bucket and trimmed."""
        padded, true_len = self.bucketer.pad_to_bucket(mel, axis=-1)
        dtype = torch.bfloat16 if self.bf16 else torch.float32
        wav = self._run(padded.to(dtype)).float()
        return wav[:, : true_len * self.hop_size]

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """mel [frames, n_mels] (or [B, frames, n_mels]) → wav [samples]
        (or [B, samples])."""
        mel = np.asarray(mel, np.float32)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        x = torch.from_numpy(mel).to(self.device).transpose(1, 2).contiguous()
        wav = self.vocode(x).cpu().numpy()
        return wav[0] if squeeze else wav
