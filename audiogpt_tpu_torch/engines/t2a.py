"""Text → audio latent-diffusion engine (Make-An-Audio class).

Counterpart of ``audiogpt_tpu/engines/t2a.py:44-455``. The reference flow
(``audio-chatgpt.py:158-199``): CLAP text context → sampler with the CFG
pair batched → VAE decode → (x+1)/2 mel → BigVGAN → best-of-n CLAP
ranking; the n candidates are the batch axis, and only the winner and the
scores leave the device. Inpainting (``audio-chatgpt.py:418-559``) encodes
the original's mel with the VAE and regenerates the masked region with the
samplers' mask blend.

With ``mesh=`` (a ``parallel.device_mesh``) the candidates shard over its
cards as the JAX engine's ``mesh`` shards them (``t2a.py:92-118``,
``_prep_candidates`` ``:296-321``): n rounds up to the ``data`` axis, the
text is encoded and the initial noise drawn once on the first card, and
each replica (its own UNet, VAE, vocoder generator and CLAP audio tower,
``engines/base.py`` ``Replicated``) runs sampler → VAE → vocoder → audio
embedding on its rows, on its own thread and stream; only the scores and
the winner leave the cards (``_sample_vocode_rank_fn`` ``:215-245``).
Inpainting and the I2A engine run on the first card's modules, as JAX runs
them on unsharded inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audiogpt_tpu_torch.dsp.mel import LDM_MEL_16K, ldm_normalize, log_mel
from audiogpt_tpu_torch.engines.base import (ParamsEntry, Replicated,
                                             run_copy, same_device)
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.diffusion.samplers import (
    DiffusionSchedule,
    Noise,
    ddim_sample,
    dpmpp_sample,
    plms_sample,
)
from audiogpt_tpu_torch.models.diffusion.unet import UNetConfig, UNetModel
from audiogpt_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from audiogpt_tpu_torch.models.textenc.clap import (
    CLAPScorer,
    CLAPTextConfig,
    CLAPTextEncoder,
    WordPieceTokenizer,
)
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

SAMPLERS = {"ddim": ddim_sample, "plms": plms_sample, "dpmpp": dpmpp_sample}
#: the samplers that take the inpaint mask blend
INPAINT_SAMPLERS = {"ddim": ddim_sample, "dpmpp": dpmpp_sample}


@dataclasses.dataclass(frozen=True)
class T2AConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    clap: CLAPTextConfig = CLAPTextConfig()
    mel_bins: int = 80
    mel_len: int = 624           # 10 s canvas (audio-chatgpt.py:202)
    inpaint_mel_len: int = 848   # inpaint canvas (audio-chatgpt.py:463)
    sample_rate: int = 16000
    hop: int = 256
    scale_factor: float = 1.0    # LDM latent scaling (ddpm_audio.py:104)
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    #: run the UNet denoiser in bfloat16 (``audiogpt_tpu/engines/t2a.py``'s
    #: ``unet_bf16``): a bf16 copy of the f32 UNet is cast once, ``x`` and
    #: the contexts go in as bf16 and ``eps`` comes back as f32; GroupNorm
    #: statistics stay f32 inside the model, the scheduler arithmetic and the
    #: VAE decode stay f32. The level-0 attention then takes the flash
    #: kernel's bf16 entry. Inpainting runs the f32 UNet, as the JAX
    #: engine's inpaint core does.
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


@ENGINES.register("t2a")
class T2AEngine(Replicated, ParamsEntry):
    name = "t2a"
    #: a trainer checkpoint's groups load by name (``ldm``'s ``unet``)
    train_group = None
    #: each replica's own copies (the vocoder and the scorer keep theirs)
    replicated = ("unet", "vae", "_run")

    def __init__(self, cfg: T2AConfig | None = None, params: dict | None = None,
                 vocoder: VocoderEngine | None = None,
                 scorer: CLAPScorer | None = None,
                 rng_seed: int = 0, mesh=None,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's ``{"unet", "vae", "clap"}`` trees as
        numpy arrays (loaded with :func:`load_jax_params`); ``None`` keeps a
        seeded random init. ``scorer``: the CLAP scorer that ranks
        ``txt2audio_best``'s candidates, on the engine's device.
        ``mesh``: a ``parallel.device_mesh`` over which a call's candidates
        shard (JAX's ``mesh=``); the engine, its vocoder and its scorer
        live on its first device, and the engine builds their replicas.
        ``device=None`` is the card (the mesh's first with a mesh), and
        raises without one."""
        self.device = self._bind_mesh(mesh, device)
        for part in (vocoder, scorer):
            if part is not None and not same_device(part.device,
                                                    self.device):
                raise ValueError(f"{type(part).__name__} on {part.device}, "
                                 f"engine on {self.device}")
        self.cfg = cfg = cfg or T2AConfig()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.unet = UNetModel(cfg.unet)
            self.vae = AutoencoderKL(cfg.vae)
            self.clap = CLAPTextEncoder(cfg.clap)
        for m in (self.unet, self.vae, self.clap):
            m.to(self.device).eval()
        if params is not None:
            self.load_jax_params(params)
        else:
            self._weights_loaded()
        self.schedule = DiffusionSchedule.linear(
            cfg.timesteps, cfg.linear_start, cfg.linear_end)
        self.tokenizer = WordPieceTokenizer(vocab_size=cfg.clap.bert.vocab_size)
        self.vocoder = vocoder
        self.scorer = scorer
        if mesh is not None:
            for part in (vocoder, scorer):
                if part is not None:
                    part.replicas(mesh)
        self._generator = torch.Generator(self.device).manual_seed(rng_seed)

    def load_jax_params(self, params: dict) -> None:
        """Load the JAX engine's ``{"unet", "vae", "clap"}`` trees (numpy
        leaves), strictly."""
        for key in ("unet", "vae", "clap"):
            load_jax_params(getattr(self, key), params[key])
        self._weights_loaded()

    def load_state_dict(self, states: dict) -> None:
        """Load f32 parameters: ``{"unet": ..., "vae": ..., "clap": ...}``
        state dicts (any subset), strictly."""
        for key, state in states.items():
            getattr(self, key).load_state_dict(state)
        self._weights_loaded()

    def _weights_loaded(self) -> None:
        # the UNet the samplers of txt2audio run (inpaint runs ``unet``),
        # and each replica's copies
        self._run = run_copy(self.unet, self.cfg.unet_bf16)
        self._replicate()

    def replica(self, i: int) -> "T2AEngine":
        """The engine as replica ``i`` of the mesh sees it: its UNet, VAE,
        vocoder and scorer views on its card."""
        view = super().replica(i)
        if self.mesh is not None:
            if self.vocoder is not None:
                view.vocoder = self.vocoder.replicas(self.mesh)[i]
            if self.scorer is not None:
                view.scorer = self.scorer.replicas(self.mesh)[i]
        return view

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
        return self._run(x.bfloat16(), t, context.bfloat16()).float()

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
        """One batched cond+uncond encode and the initial noise of the
        whole batch, on the first device, for ``n_samples`` rounded up to
        the mesh's ``data`` axis."""
        cfg = self.cfg
        n_samples = self._rows(n_samples)
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
        vocoder attached ``(mels, wavs [n, samples])``, as numpy arrays; n
        rounded up to the mesh's ``data`` axis."""
        ctx, uc, x_T = self._prep_candidates(text, n_samples, seed)

        def run(rep, ctx, uc, x_T):
            mel01 = rep.sample_core(ctx, uc, x_T, scale, ddim_steps,
                                    sampler)[:, 0]         # [n, bins, frames]
            return mel01, (None if rep.vocoder is None
                           else rep.vocoder.vocode(mel01))

        outs = self._on_replicas(run, self._shard(ctx, uc, x_T))
        mels = np.concatenate([m.transpose(1, 2).cpu().numpy()
                               for m, _ in outs])
        if self.vocoder is None:
            return mels
        return mels, np.concatenate([w.cpu().numpy() for _, w in outs])

    @torch.inference_mode()
    def sample_vocode_rank(self, text: str, context: torch.Tensor,
                           uncond: torch.Tensor, x_T: torch.Tensor,
                           guidance: float, n_steps: int,
                           sampler: str = "ddim"):
        """The ranked core (the JAX engine's ``_sample_vocode_rank_fn``):
        sampler → VAE decode → vocoder → CLAP scores of all candidates at
        their full length → argmax. → ``(mel01 [mel_bins, frames], wav [T])``
        of the winner, on its card, and ``scores [n]`` on the first.

        With a mesh the rows of ``context``, ``uncond`` and ``x_T`` (n a
        multiple of its ``data`` axis) shard over the replicas, as
        ``P("data")`` shards them: each runs the whole chain on its rows
        with the text embedding (computed once, on the first card) copied
        to its card; the scores are gathered on the first card."""
        t = self.scorer.text_embedding(text)

        def run(rep, ctx, uc, x_T):
            mel01 = rep.sample_core(ctx, uc, x_T, guidance, n_steps,
                                    sampler)[:, 0]
            wavs = rep.vocoder.vocode(mel01)
            return mel01, wavs, rep.scorer.audio_similarity(
                t.to(rep.device), wavs)

        outs = self._on_replicas(run, self._shard(context, uncond, x_T))
        scores = torch.cat([s.to(self.device) for _, _, s in outs])
        replica, row = divmod(int(scores.argmax()), outs[0][0].shape[0])
        mel01, wavs, _ = outs[replica]
        return mel01[row], wavs[row], scores

    def select_best(self, text: str, wavs) -> int:
        """Best-of-n CLAP re-ranking (``select_best_audio``,
        audio-chatgpt.py:185-199); index 0 when no scorer is attached."""
        if self.scorer is None:
            return 0
        return self.scorer.select_best(text, wavs)

    def txt2audio_best(self, text: str, n_samples: int = 3,
                       ddim_steps: int | None = None, scale: float = 1.5,
                       seed: int | None = None, sampler: str | None = None):
        """The best-of-n tool call (audio-chatgpt.py:158-199) with the
        engine's production sampler (``cfg.tool_sampler`` /
        ``cfg.tool_steps``). → ``(mel [frames, mel_bins], wav [T] or None,
        scores [n])`` as numpy; ``scores`` are the candidates' CLAP
        similarities, one per candidate (n rounded up to the mesh's ``data``
        axis). Without a vocoder or a scorer it returns candidate 0 with
        zero scores, as the JAX engine does."""
        cfg = self.cfg
        ddim_steps = cfg.tool_steps if ddim_steps is None else ddim_steps
        sampler = cfg.tool_sampler if sampler is None else sampler
        if self.vocoder is None or self.scorer is None:
            out = self.txt2audio(text, n_samples=n_samples,
                                 ddim_steps=ddim_steps, scale=scale,
                                 seed=seed, sampler=sampler)
            scores = np.zeros(self._rows(n_samples), np.float32)
            if self.vocoder is None:
                return out[0], None, scores
            return out[0][0], out[1][0], scores
        ctx, uc, x_T = self._prep_candidates(text, n_samples, seed)
        mel01, wav, scores = self.sample_vocode_rank(
            text, ctx, uc, x_T, scale, ddim_steps, sampler)
        return (mel01.T.cpu().numpy(), wav.cpu().numpy(),
                scores.cpu().numpy())

    # -- inpaint ------------------------------------------------------------
    @torch.inference_mode()
    def inpaint_core(self, mel01: torch.Tensor, mask_latent: torch.Tensor,
                     context: torch.Tensor, uncond: torch.Tensor,
                     x_T: torch.Tensor, noise: Noise, guidance: float,
                     n_steps: int, sampler: str = "ddim") -> torch.Tensor:
        """mel01 [1, 1, mel_bins, frames] in [0, 1] and the latent mask
        (1 = keep) → regenerated mel01 (the JAX engine's ``_inpaint_core``):
        VAE encode (the posterior's mode), the sampler with the mask blend
        from ``x_T`` with per-step ``noise``, VAE decode. The UNet runs in
        f32 whatever ``unet_bf16`` says, as the JAX core does."""
        cfg = self.cfg
        if sampler not in INPAINT_SAMPLERS:
            raise ValueError(f"inpaint sampler {sampler!r}: one of "
                             f"{sorted(INPAINT_SAMPLERS)}")
        z0 = self.vae.encode(mel01 * 2.0 - 1.0).mode() * cfg.scale_factor
        z = INPAINT_SAMPLERS[sampler](
            self.unet, self.schedule, x_T, context, uncond, n_steps=n_steps,
            guidance_scale=guidance, mask=mask_latent, x0=z0, noise=noise)
        mel = self.vae.decode(z / cfg.scale_factor)
        return ((mel + 1.0) / 2.0).clamp(0.0, 1.0)

    def inpaint_inputs(self, wav: np.ndarray, mask_time: np.ndarray):
        """The original and the mask on the inpaint canvas
        (``cfg.inpaint_mel_len`` frames, audio-chatgpt.py:463-470): the wav
        padded or cut to it, its normalised mel, and the mask pooled to the
        latent grid. → ``(mel01 [1, 1, mel_bins, frames], mask_latent
        [1, C, mel_bins/f, frames/f])`` on the device."""
        cfg = self.cfg
        frames, f = cfg.inpaint_mel_len, cfg.vae_factor
        n = frames * cfg.hop
        wav = np.asarray(wav, np.float32)
        wav = np.pad(wav, (0, max(0, n - len(wav))))[:n]
        spec = dataclasses.replace(LDM_MEL_16K, sr=cfg.sample_rate,
                                   hop=cfg.hop, n_mels=cfg.mel_bins)
        mel = ldm_normalize(log_mel(torch.from_numpy(wav).to(self.device),
                                    spec))[:frames]        # [frames, bins]
        mel01 = mel.T[None, None].contiguous()

        mask = np.asarray(mask_time, np.float32)
        lat_h, lat_w = cfg.mel_bins // f, frames // f
        if mask.ndim == 1:
            # a time mask: max-pooled by the VAE factor, broadcast over
            # frequency
            mask = np.pad(mask, (0, max(0, frames - len(mask))))[:frames]
            m = np.broadcast_to(mask.reshape(lat_w, f).max(axis=1),
                                (lat_h, lat_w))
        else:
            # a [frames, mel_bins] sketch mask (keep where not drawn): the
            # time axis padded with keep, area-mean pooled to the latent
            # grid
            mask = np.pad(mask, ((0, max(0, frames - mask.shape[0])), (0, 0)),
                          constant_values=1.0)[:frames]
            m = mask.T.reshape(lat_h, f, lat_w, f).mean(axis=(1, 3))
        mask_latent = torch.from_numpy(np.ascontiguousarray(m)).to(
            self.device).expand(1, cfg.unet.in_channels, lat_h, lat_w)
        return mel01, mask_latent

    def inpaint(self, wav: np.ndarray, mask_time: np.ndarray,
                text: str = "", ddim_steps: int = 100, scale: float = 1.0,
                sampler: str = "ddim") -> np.ndarray:
        """``mask_time`` with 1 = keep the original; regenerates the rest.
        A 1-D time mask ``[frames]`` (text-specified ranges) or a 2-D
        time-frequency mask ``[frames, mel_bins]`` (the UI's sketch).
        → wav [inpaint_mel_len · hop] with a vocoder attached, else the mel
        [frames, mel_bins], as numpy."""
        mel01, mask_latent = self.inpaint_inputs(wav, mask_time)
        if scale != 1.0:
            ctx, uc = self.encode_text([text, ""]).chunk(2)
        else:
            ctx = uc = self.encode_text([text])
        x_T = torch.randn((1,) + mask_latent.shape[1:],
                          generator=self._generator, device=self.device)
        out = self.inpaint_core(mel01, mask_latent, ctx, uc, x_T,
                                self._generator, scale, ddim_steps, sampler)
        if self.vocoder is None:
            return out[0, 0].T.cpu().numpy()
        return self.vocoder.vocode(out[:, 0])[0].cpu().numpy()
