"""Text → image engine: a StableDiffusion-class LDM on the shared diffusion
stack (the agent's "Generate Image From User Input Text" tool).

Counterpart of ``audiogpt_tpu/engines/t2i.py:38-221``, the mesh included:
with ``mesh=`` (a ``parallel.device_mesh``) ``txt2img`` rounds n up to its
``data`` axis, encodes the prompt and draws the initial noise once on the
first card and runs each replica's rows on its own UNet and VAE, thread
and stream (``t2i.py:183-205``; ``engines/base.py`` ``Replicated``); the
CLIP text tower and the prompt refiner run on the first card. The
reference's T2I tool calls a hosted SD-1.5 pipeline
(``audio-chatgpt.py``'s ``T2I``); here the UNet, VAE and samplers that
serve T2A are built at the SD-1.x shape with a CLIP ViT-L/14 text tower as
the conditioner: the CLIP tower's post-LN token states (77 × 768) are the
cross-attention context, the sampler batches the CFG pair, the VAE decodes
``z / 0.18215`` and the image is ``clip((x + 1) / 2)``.

On the card the UNet's attention at its three upper levels takes the flash
kernel: at 512 × 512 (64 × 64 latents) the self-attention of 4096, 1024
and 256 tokens (D = 40, 80, 160) and the cross-attention of the first two
levels on the 77 context tokens; the 256-token level's cross-attention
(19 712 pairs) and the 8 × 8 middle block stay plain.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from audiogpt_tpu_torch.engines.base import (ParamsEntry, Replicated,
                                             run_copy)
from audiogpt_tpu_torch.models.diffusion.samplers import (
    DiffusionSchedule,
    ddim_sample,
    dpmpp_sample,
    plms_sample,
)
from audiogpt_tpu_torch.models.diffusion.unet import UNetConfig, UNetModel
from audiogpt_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from audiogpt_tpu_torch.models.textenc.clip import (CLIPTextConfig,
                                                    CLIPTextTower)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

#: sampler by name; any other name runs DDIM, as the JAX core does
SAMPLERS = {"plms": plms_sample, "dpmpp": dpmpp_sample}
SOT, EOT = 49406, 49407     # CLIP's <start_of_text>, <end_of_text>


@dataclasses.dataclass(frozen=True)
class T2IConfig:
    #: SD-1.x UNet: 320 channels, 4 levels, attention at ds 1/2/4,
    #: 768-wide context
    unet: UNetConfig = UNetConfig(
        in_channels=4, out_channels=4, model_channels=320,
        num_res_blocks=2, attention_resolutions=(1, 2, 4),
        channel_mult=(1, 2, 4, 4), num_heads=8, context_dim=768)
    #: f8 image VAE (RGB)
    vae: VAEConfig = VAEConfig(ch=128, ch_mult=(1, 2, 4, 4),
                               num_res_blocks=2, attn_resolutions=(),
                               in_channels=3, out_ch=3, z_channels=4,
                               embed_dim=4, resolution=256)
    #: CLIP ViT-L/14 text tower (SD's conditioner)
    text: CLIPTextConfig = CLIPTextConfig(
        vocab_size=49408, context_length=77, width=768, layers=12,
        heads=12, embed_dim=768)
    height: int = 512
    width: int = 512
    scale_factor: float = 0.18215
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    #: run the UNet in bfloat16 on a copy cast once per weight load (as
    #: ``T2AConfig.unet_bf16``); the schedule and the VAE stay f32
    unet_bf16: bool = False

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.vae.ch_mult) - 1)

    @property
    def latent_hw(self) -> tuple[int, int]:
        return self.height // self.vae_factor, self.width // self.vae_factor


class T2IEngine(Replicated, ParamsEntry):
    name = "t2i"
    #: a trainer checkpoint's groups load by name (``unet``, ``vae``,
    #: ``text``)
    train_group = None
    #: each replica's own copies
    replicated = ("unet", "vae", "_run")

    def __init__(self, cfg: T2IConfig | None = None,
                 params: dict | None = None,
                 tokenizer="auto", mesh=None, media_root: str = ".",
                 rng_seed: int = 0, text_refiner=None,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's ``{"unet", "vae", "text"}`` trees as
        numpy arrays; ``None`` keeps a seeded random init. ``tokenizer``:
        text → bare CLIP BPE ids; ``"auto"`` loads the bundled CLIP merges
        (:class:`~audiogpt_tpu_torch.text.bpe.ClipTokenizer`), ``None``
        drops the prompt (with a warning). ``mesh``: a
        ``parallel.device_mesh`` over which a call's images shard (JAX's
        ``mesh=``). ``text_refiner``: any ``str → str`` run over the prompt
        first (the reference's MagicPrompt stage). ``device=None`` is the
        card (the mesh's first with a mesh), and raises without one."""
        self.device = self._bind_mesh(mesh, device)
        self.cfg = cfg = cfg or T2IConfig()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.unet = UNetModel(cfg.unet)
            self.vae = AutoencoderKL(cfg.vae)
            self.text = CLIPTextTower(cfg.text)
        for m in (self.unet, self.vae, self.text):
            m.to(self.device).eval()
        if params is not None:
            self.load_jax_params(params)
        else:
            self._weights_loaded()
        self.schedule = DiffusionSchedule.linear(
            cfg.timesteps, cfg.linear_start, cfg.linear_end)
        if tokenizer == "auto":
            from audiogpt_tpu_torch.text.bpe import ClipTokenizer

            tokenizer = ClipTokenizer()
        self.tokenizer = tokenizer
        self.text_refiner = text_refiner
        self.media_root = media_root
        self._generator = torch.Generator(self.device).manual_seed(rng_seed)

    def load_jax_params(self, params: dict) -> None:
        """Load the JAX engine's ``{"unet", "vae", "text"}`` trees (numpy
        leaves), strictly."""
        for key in ("unet", "vae", "text"):
            load_jax_params(getattr(self, key), params[key])
        self._weights_loaded()

    def load_state_dict(self, states: dict) -> None:
        """Load f32 parameters: ``{"unet": ..., "vae": ..., "text": ...}``
        state dicts (any subset), strictly."""
        for key, state in states.items():
            getattr(self, key).load_state_dict(state)
        self._weights_loaded()

    def _weights_loaded(self) -> None:
        self._run = run_copy(self.unet, self.cfg.unet_bf16)
        self._replicate()

    # -- conditioning -------------------------------------------------------
    @torch.inference_mode()
    def encode_ids(self, ids: np.ndarray) -> torch.Tensor:
        """ids [n, 77] → the CLIP tower's token states [n, 77, 768]."""
        ids = torch.from_numpy(np.asarray(ids)).long().to(self.device)
        return self.text(ids, return_sequence=True)

    def _tokenize(self, texts: list[str]) -> np.ndarray:
        """[SOT, ids, EOT] padded with EOT (not 0) to the context length,
        as the JAX engine frames them."""
        length = self.cfg.text.context_length
        if self.tokenizer is None and any(texts):
            from audiogpt_tpu_torch.text.bpe import warn_fallback

            warn_fallback("T2IEngine",
                          "tokenizer disabled: prompts are DROPPED "
                          "([SOT, EOT] conditioning only)")
        ids = np.full((len(texts), length), EOT, np.int32)
        for i, t in enumerate(texts):
            toks = [SOT] + (list(self.tokenizer(t))[: length - 2]
                            if self.tokenizer else []) + [EOT]
            ids[i, : len(toks)] = toks
        return ids

    # -- core ---------------------------------------------------------------
    def eps(self, x: torch.Tensor, t: torch.Tensor,
            context: torch.Tensor) -> torch.Tensor:
        """The denoiser as the samplers call it: f32 in and out, bf16 inside
        under ``cfg.unet_bf16``."""
        if not self.cfg.unet_bf16:
            return self.unet(x, t, context)
        return self._run(x.bfloat16(), t, context.bfloat16()).float()

    @torch.inference_mode()
    def sample(self, context: torch.Tensor, uncond: torch.Tensor,
               x_T: torch.Tensor, guidance: float, n_steps: int,
               sampler: str = "ddim") -> torch.Tensor:
        """The JAX engine's ``_sample_fn``: the sampler (``"plms"``,
        ``"dpmpp"``, DDIM for any other name) with the CFG pair batched from
        ``x_T`` [n, 4, h, w], VAE decode of ``z / scale_factor``
        → images [n, 3, H, W] in [0, 1] on the device."""
        z = SAMPLERS.get(sampler, ddim_sample)(
            self.eps, self.schedule, x_T, context, uncond, n_steps=n_steps,
            guidance_scale=guidance)
        img = self.vae.decode(z / self.cfg.scale_factor)
        return ((img + 1.0) / 2.0).clamp(0.0, 1.0)

    # -- public API ---------------------------------------------------------
    def txt2img(self, text: str, n_samples: int = 1, steps: int = 50,
                scale: float = 7.5, seed: int | None = None,
                sampler: str = "ddim") -> np.ndarray:
        """→ images [n, H, W, 3] float32 in [0, 1], n rounded up to the
        mesh's ``data`` axis. The initial noise of the whole batch comes
        from the engine's generator, or one seeded with ``seed``, on the
        first card; each replica samples its rows."""
        if self.text_refiner is not None and text:
            text = self.text_refiner(text)
        n_samples = self._rows(n_samples)
        both = self.encode_ids(self._tokenize([text] * n_samples
                                              + [""] * n_samples))
        ctx, uc = both[:n_samples], both[n_samples:]
        gen = (self._generator if seed is None
               else torch.Generator(self.device).manual_seed(seed))
        h, w = self.cfg.latent_hw
        x_T = torch.randn((n_samples, self.cfg.unet.in_channels, h, w),
                          generator=gen, device=self.device)
        imgs = self._on_replicas(
            lambda rep, c, u, x: rep.sample(c, u, x, scale, steps, sampler),
            self._shard(ctx, uc, x_T))
        return np.concatenate([img.permute(0, 2, 3, 1).cpu().numpy()
                               for img in imgs])

    def __call__(self, text: str) -> str:
        """The toolset's ``t2i`` slot: text → the saved PNG's path, relative
        to ``media_root`` (``image/<uuid8>.png``). On a mesh every replica
        draws an image and the first is saved, as in JAX."""
        from PIL import Image

        from audiogpt_tpu_torch.agent.tools import new_media_path

        img = self.txt2img(text, n_samples=1)
        full = new_media_path("image", "png", root=self.media_root)
        Image.fromarray((img[0] * 255).astype(np.uint8)).save(full)
        return os.path.relpath(full, self.media_root)
