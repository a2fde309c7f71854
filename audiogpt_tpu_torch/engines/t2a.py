"""Text → audio latent-diffusion engine (Make-An-Audio class).

Counterpart of ``audiogpt_tpu/engines/t2a.py:44-392``. The reference flow
(``audio-chatgpt.py:158-199``): CLAP text context → sampler with the CFG
pair batched → VAE decode → (x+1)/2 mel → BigVGAN → best-of-n CLAP ranking.
The n candidates are the batch axis. The ranking needs the CLAP audio tower,
which comes with a later slice; until then ``txt2audio_best`` returns
candidate 0 with zero scores, as the JAX engine does with no scorer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audiogpt_tpu_torch.engines.base import resolve_device
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.diffusion.samplers import (
    DiffusionSchedule,
    ddim_sample,
    dpmpp_sample,
    plms_sample,
)
from audiogpt_tpu_torch.models.diffusion.unet import UNetConfig, UNetModel
from audiogpt_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from audiogpt_tpu_torch.models.textenc.clap import (
    CLAPTextConfig,
    CLAPTextEncoder,
    WordPieceTokenizer,
)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

SAMPLERS = {"ddim": ddim_sample, "plms": plms_sample, "dpmpp": dpmpp_sample}


@dataclasses.dataclass(frozen=True)
class T2AConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    clap: CLAPTextConfig = CLAPTextConfig()
    mel_bins: int = 80
    mel_len: int = 624           # 10 s canvas (audio-chatgpt.py:202)
    sample_rate: int = 16000
    hop: int = 256
    scale_factor: float = 1.0    # LDM latent scaling (ddpm_audio.py:104)
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    #: run the UNet denoiser in bfloat16 (``audiogpt_tpu/engines/t2a.py``'s
    #: ``unet_bf16``): its f32 parameters are cast to bf16 once, ``x`` and
    #: the contexts go in as bf16 and ``eps`` comes back as f32; GroupNorm
    #: statistics stay f32 inside the model, the scheduler arithmetic and the
    #: VAE decode stay f32. The level-0 attention then takes the flash
    #: kernel's bf16 entry.
    unet_bf16: bool = False
    #: sampler of the agent tool call: DPM-Solver++(2M)-12, measured
    #: output-equivalent to the reference's DDIM-100 on this schedule by the
    #: JAX package (tools/sampler_equivalence.py)
    tool_sampler: str = "dpmpp"
    tool_steps: int = 12

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae.ch_mult) - 1)

    @property
    def latent_hw(self) -> tuple[int, int]:
        return self.mel_bins // self.vae_factor, self.mel_len // self.vae_factor


class T2AEngine:
    name = "t2a"

    def __init__(self, cfg: T2AConfig | None = None, params: dict | None = None,
                 vocoder: VocoderEngine | None = None,
                 rng_seed: int = 0,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's ``{"unet", "vae", "clap"}`` trees as
        numpy arrays (loaded with :func:`load_jax_params`); ``None`` keeps a
        seeded random init. ``device=None`` is the card, and raises without
        one."""
        self.device = resolve_device(device)
        self.cfg = cfg = cfg or T2AConfig()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.unet = UNetModel(cfg.unet)
            self.vae = AutoencoderKL(cfg.vae)
            self.clap = CLAPTextEncoder(cfg.clap)
        if params is not None:
            for key in ("unet", "vae", "clap"):
                load_jax_params(getattr(self, key), params[key])
        for m in (self.unet, self.vae, self.clap):
            m.to(self.device).eval()
        if cfg.unet_bf16:
            self.unet.to(torch.bfloat16)
        self.schedule = DiffusionSchedule.linear(
            cfg.timesteps, cfg.linear_start, cfg.linear_end)
        self.tokenizer = WordPieceTokenizer(vocab_size=cfg.clap.bert.vocab_size)
        self.vocoder = vocoder
        self._generator = torch.Generator(self.device).manual_seed(rng_seed)

    # -- conditioning -------------------------------------------------------
    @torch.inference_mode()
    def encode_text(self, texts: list[str]) -> torch.Tensor:
        """→ context [len(texts), max_length, d_proj] on the device."""
        ids, masks = zip(*(self.tokenizer.encode(t, self.cfg.clap.max_length)
                           for t in texts))
        ids = torch.from_numpy(np.stack(ids)).long().to(self.device)
        masks = torch.from_numpy(np.stack(masks)).long().to(self.device)
        return self.clap(ids, masks)

    # -- core ---------------------------------------------------------------
    def eps(self, x: torch.Tensor, t: torch.Tensor,
            context: torch.Tensor) -> torch.Tensor:
        """The denoiser as the samplers call it: f32 ``x`` in, f32 ``eps``
        out, in bf16 inside under ``cfg.unet_bf16``."""
        if not self.cfg.unet_bf16:
            return self.unet(x, t, context)
        return self.unet(x.bfloat16(), t, context.bfloat16()).float()

    @torch.inference_mode()
    def sample_core(self, context: torch.Tensor, uncond: torch.Tensor,
                    x_T: torch.Tensor, guidance: float, n_steps: int,
                    sampler: str = "ddim") -> torch.Tensor:
        """Sampler loop → VAE decode → mel01 [B, 1, mel_bins, frames] in [0, 1]
        (the JAX engine's ``_sample_core``)."""
        cfg = self.cfg
        z = SAMPLERS[sampler](self.eps, self.schedule, x_T, context, uncond,
                              n_steps=n_steps, guidance_scale=guidance)
        mel = self.vae.decode(z / cfg.scale_factor)
        return ((mel + 1.0) / 2.0).clamp(0.0, 1.0)

    # -- public API ---------------------------------------------------------
    def _prep_candidates(self, text: str, n_samples: int, seed: int | None):
        """One batched cond+uncond encode and the initial noise."""
        cfg = self.cfg
        both = self.encode_text([text] * n_samples + [""] * n_samples)
        ctx, uc = both[:n_samples], both[n_samples:]
        gen = (self._generator if seed is None
               else torch.Generator(self.device).manual_seed(seed))
        h, w = cfg.latent_hw
        x_T = torch.randn((n_samples, cfg.unet.in_channels, h, w),
                          generator=gen, device=self.device)
        return ctx, uc, x_T

    def txt2audio(self, text: str, n_samples: int = 3, ddim_steps: int = 100,
                  scale: float = 1.5, seed: int | None = None,
                  sampler: str = "ddim"):
        """→ candidate mels [n, frames, mel_bins] in [0, 1], and with a
        vocoder attached ``(mels, wavs [n, samples])``, as numpy arrays."""
        ctx, uc, x_T = self._prep_candidates(text, n_samples, seed)
        mel01 = self.sample_core(ctx, uc, x_T, scale, ddim_steps,
                                 sampler)[:, 0]             # [n, bins, frames]
        mels = mel01.transpose(1, 2).cpu().numpy()
        if self.vocoder is None:
            return mels
        return mels, self.vocoder.vocode(mel01).cpu().numpy()

    def txt2audio_best(self, text: str, n_samples: int = 3,
                       ddim_steps: int | None = None, scale: float = 1.5,
                       seed: int | None = None, sampler: str | None = None):
        """The best-of-n tool call (audio-chatgpt.py:158-199) with the
        engine's production sampler (``cfg.tool_sampler`` /
        ``cfg.tool_steps``). → ``(mel [frames, mel_bins], wav [T] or None,
        scores [n])`` as numpy; with no scorer yet the scores are zeros and
        candidate 0 is returned."""
        cfg = self.cfg
        out = self.txt2audio(
            text, n_samples=n_samples,
            ddim_steps=cfg.tool_steps if ddim_steps is None else ddim_steps,
            scale=scale, seed=seed,
            sampler=cfg.tool_sampler if sampler is None else sampler)
        scores = np.zeros(n_samples, np.float32)
        if self.vocoder is None:
            return out[0], None, scores
        mels, wavs = out
        return mels[0], wavs[0], scores
