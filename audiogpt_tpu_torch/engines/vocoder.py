"""Vocoder engine: mel → wav, static-shape bucketed; and ``denoise``.

Counterpart of ``audiogpt_tpu/engines/vocoder.py:29-162``: the kinds
``hifigan`` (the default; with ``use_nsf`` the call takes f0), ``bigvgan``,
``pwg`` and ``melgan``, each with the bf16 mode, shared by the TTS engine
and the diffusion tools.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from audiogpt_tpu_torch.engines.base import (
    Bucketer,
    ParamsEntry,
    device_views,
    resolve_device,
    run_copy,
)
from audiogpt_tpu_torch.models.vocoder import (
    BigVGANConfig,
    BigVGANGenerator,
    HifiGANConfig,
    HifiGANGenerator,
    MelGANConfig,
    MelGANGenerator,
    PWGConfig,
    PWGGenerator,
)
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048)

#: kind → (config class, generator class)
KINDS = {"hifigan": (HifiGANConfig, HifiGANGenerator),
         "bigvgan": (BigVGANConfig, BigVGANGenerator),
         "pwg": (PWGConfig, PWGGenerator),
         "melgan": (MelGANConfig, MelGANGenerator)}


@ENGINES.register("vocoder")
class VocoderEngine(ParamsEntry):
    name = "vocoder"
    #: the generator's group of the ``vocoder_gan`` recipe
    train_group = "gen"

    def __init__(self, kind: str = "hifigan", cfg: Any = None,
                 params: Any = None, buckets=DEFAULT_BUCKETS,
                 rng_seed: int = 0, bf16: bool = False,
                 device: str | torch.device | None = None):
        """``params``: a JAX parameter tree as numpy arrays (loaded with
        :func:`load_jax_params`); ``None`` keeps a seeded random init.
        ``device=None`` is the card, and raises without one.

        ``bf16``: the JAX engine's throughput mode (its ``bf16``): the
        generator is cast to bf16 once (BigVGAN's snake log-α/β too), the
        mel goes in as bf16 and the wav comes out as f32; with BigVGAN
        every AMP activation takes ``snake_aa``'s bf16 entry. NSF's f0 stays
        f32 and the harmonic source is computed in f32, then cast (the JAX
        engine casts f0 to bf16 and runs the phase's running sum in it).
        ``model`` keeps the f32 parameters; :meth:`load_state_dict` loads
        into it and casts again.

        With NSF (``HifiGANConfig(use_nsf=True)``) each call draws the
        harmonic source's noise from the engine's generator, seeded with
        ``rng_seed`` (the JAX engine splits a key per call)."""
        if kind not in KINDS:
            raise ValueError(f"vocoder kind {kind!r}")
        cfg_cls, gen_cls = KINDS[kind]
        self.kind = kind
        self.device = resolve_device(device)
        self.cfg = cfg or cfg_cls()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.model = gen_cls(self.cfg)
        if params is not None:
            load_jax_params(self.model, params)
        self.model.to(self.device).eval()
        self.n_mels = getattr(self.cfg, "in_channels", None) \
            or getattr(self.cfg, "num_mels", 80)
        self.bf16 = bf16
        self._gen = torch.Generator(self.device).manual_seed(rng_seed)
        self._replica_sets: dict[tuple, list] = {}
        self._weights_loaded()
        self.bucketer = Bucketer(buckets)

    def _weights_loaded(self) -> None:
        # ``model`` keeps the f32 parameters; the run copy is cast again,
        # and every mesh's replicas are copied again
        self._run = run_copy(self.model, self.bf16)
        self._replica_sets = {mesh: self._views(mesh)
                              for mesh in self._replica_sets}

    def replicas(self, mesh) -> list["VocoderEngine"]:
        """The engine on every entry of ``mesh`` (a
        ``parallel.device_mesh`` whose first entry is the engine's device),
        for a diffusion engine whose candidates shard over it: the engine
        itself, then views with their own copy of the generator and of its
        bf16 run copy on their device. Built at a mesh's first call and
        again at every weight load."""
        key = tuple(mesh)
        if key not in self._replica_sets:
            self._replica_sets[key] = self._views(key)
        return self._replica_sets[key]

    def _views(self, devices: tuple) -> list["VocoderEngine"]:
        views = device_views(self, devices, ("model", "_run"))
        for view in views[1:]:
            view._gen = torch.Generator(view.device).manual_seed(
                self._gen.initial_seed())
            view._replica_sets = {}
        return views

    @property
    def hop_size(self) -> int:
        return self.cfg.hop_size

    @property
    def use_nsf(self) -> bool:
        return self.kind == "hifigan" and self.cfg.use_nsf

    def warmup(self, buckets=None) -> None:
        for b in buckets or self.bucketer.buckets:
            self(np.zeros((b, self.n_mels), np.float32))

    @torch.inference_mode()
    def vocode(self, mel: torch.Tensor, f0: torch.Tensor | None = None,
               noise=None) -> torch.Tensor:
        """mel [B, n_mels, frames] on the engine's device → f32 wav
        [B, frames · hop], run at the frames' bucket and trimmed.

        ``f0`` [B, frames] feeds the NSF source (zeros if absent);
        ``noise`` is the generator's randomness: NSF draws (a generator or
        replayed tensors, ``models/vocoder/hifigan.py``; default the
        engine's generator) or PWG's ``[B, T]`` noise at the bucket's
        length (default a generator seeded with 0, as in JAX)."""
        padded, true_len = self.bucketer.pad_to_bucket(mel, axis=-1)
        dtype = torch.bfloat16 if self.bf16 else torch.float32
        padded = padded.to(dtype)
        if self.use_nsf:
            if f0 is None:
                f0 = mel.new_zeros(mel.shape[0], mel.shape[-1])
            f0, _ = self.bucketer.pad_to_bucket(f0, axis=-1)
            wav = self._run(padded, f0.float(),
                            self._gen if noise is None else noise)
        elif self.kind == "pwg":
            wav = self._run(padded, noise)
        else:
            wav = self._run(padded)
        return wav.float()[:, : true_len * self.hop_size]

    def __call__(self, mel: np.ndarray,
                 f0: np.ndarray | None = None) -> np.ndarray:
        """mel [frames, n_mels] (or [B, frames, n_mels]) → wav [samples]
        (or [B, samples]); ``f0`` [frames] (or [B, frames]) with NSF."""
        mel = np.asarray(mel, np.float32)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        x = torch.from_numpy(mel).to(self.device).transpose(1, 2).contiguous()
        if f0 is not None:
            f0 = torch.from_numpy(np.asarray(f0, np.float32)).to(
                self.device).reshape(x.shape[0], -1)
        wav = self.vocode(x, f0).cpu().numpy()
        return wav[0] if squeeze else wav


def denoise(wav: np.ndarray, v: float = 0.1, n_fft: int = 1024,
            hop: int = 256, win_length: int | None = None,
            device: str | torch.device | None = None) -> np.ndarray:
    """Spectral-magnitude-subtraction denoise of vocoder output
    (``NeuralSeq/vocoders/vocoder_utils.py:7``: |S| − v floored at 0, the
    mixture's phase kept, iSTFT), on ``device`` (None = the card)."""
    from audiogpt_tpu_torch.dsp.stft import istft, stft

    x = torch.from_numpy(np.asarray(wav, np.float32)).to(
        resolve_device(device))
    with torch.inference_mode():
        spec = stft(x, n_fft, hop, win_length, pad_mode="constant")
        mag = spec.abs()
        unit = torch.where(mag - v > 0, spec / mag.clamp_min(1e-9),
                           torch.zeros_like(spec))
        out = istft((mag - v).clamp_min(0.0) * unit, n_fft, hop, win_length,
                    length=x.shape[-1])
    return out.cpu().numpy()
