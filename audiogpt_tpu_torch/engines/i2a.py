"""Image → audio engine (the reference's I2A tool, ``audio-chatgpt.py:214``).

Counterpart of ``audiogpt_tpu/engines/i2a.py:28-98``: the T2A engine's
latent-diffusion core conditioned on the L2-normalised CLIP image embedding
as a length-1 context (``img2audio``:232-253: DDIM-100, scale 3, one
sample, seed 55), with the CLIP text embedding of ``""`` as the
unconditional branch. It shares the T2A engine's UNet, VAE and vocoder and
adds no diffusion code: the sampler is ``T2AEngine.sample_core``.
"""

from __future__ import annotations

import torch

from audiogpt_tpu_torch.engines.base import (ParamsEntry, resolve_device,
                                             same_device)
from audiogpt_tpu_torch.engines.t2a import T2AEngine
from audiogpt_tpu_torch.models.textenc.clip import (
    CLIPTextConfig,
    CLIPTextTower,
    CLIPVisionConfig,
    CLIPVisionEncoder,
    preprocess_image,
)
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


@ENGINES.register("i2a")
class I2AEngine(ParamsEntry):
    name = "i2a"
    train_group = None

    def __init__(self, t2a: T2AEngine,
                 vision_cfg: CLIPVisionConfig | None = None,
                 text_cfg: CLIPTextConfig | None = None,
                 vision_params=None, text_params=None, rng_seed: int = 0,
                 device: str | torch.device | None = None):
        """``vision_params`` / ``text_params``: the JAX towers' param trees
        as numpy arrays; ``None`` keeps a seeded random init. ``device`` is
        the T2A engine's (``None`` is the card, and raises without one); on
        a T2A engine with a mesh, its first card, whose modules I2A runs."""
        self.device = resolve_device(device)
        if not same_device(t2a.device, self.device):
            raise ValueError(f"T2A engine on {t2a.device}, I2A engine on "
                             f"{self.device}")
        self.t2a = t2a
        ctx_dim = t2a.cfg.unet.context_dim
        self.vision_cfg = vision_cfg or CLIPVisionConfig(embed_dim=ctx_dim)
        self.text_cfg = text_cfg or CLIPTextConfig(embed_dim=ctx_dim)
        if self.vision_cfg.embed_dim != ctx_dim:
            raise ValueError(
                f"CLIP embed_dim {self.vision_cfg.embed_dim} must match UNet "
                f"context_dim {ctx_dim}")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.vision = CLIPVisionEncoder(self.vision_cfg)
            self.text = CLIPTextTower(self.text_cfg)
        for m in (self.vision, self.text):
            m.to(self.device).eval()
        if vision_params is not None:
            load_jax_params(self.vision, vision_params)
        if text_params is not None:
            load_jax_params(self.text, text_params)
        self._weights_loaded()

    def load_jax_params(self, params: dict) -> None:
        """Load the CLIP towers' ``{"vision", "text"}`` trees (numpy
        leaves; either may be absent), strictly. A tree with neither key is
        one tower's, as ``import_ckpt --family clip_vision`` writes it, and
        loads into the vision tower, strictly (a text tower's tree raises).
        The JAX engine keeps no ``params`` of its own, and its app's
        ``--ckpt i2a=`` sets an attribute that nothing reads."""
        towers = {k: params[k] for k in ("vision", "text") if k in params}
        for key, tree in (towers or {"vision": params}).items():
            load_jax_params(getattr(self, key), tree)
        self._weights_loaded()

    def load_state_dict(self, states: dict) -> None:
        """Load ``{"vision": ..., "text": ...}`` state dicts (any subset),
        strictly."""
        for key, state in states.items():
            getattr(self, key).load_state_dict(state)
        self._weights_loaded()

    def _weights_loaded(self) -> None:
        # the unconditional embedding is computed again at its next use
        self._uncond = None

    @property
    @torch.inference_mode()
    def uncond(self) -> torch.Tensor:
        """The normalised CLIP text embedding of ``""`` as [1, 1, D]
        (modules.py:338), computed at its first use and kept."""
        if self._uncond is None:
            toks = torch.zeros(1, self.text_cfg.context_length,
                               dtype=torch.long)
            toks[0, 0] = 1  # start token; EOT pooling picks the max id
            self._uncond = self.text(toks.to(self.device))[:, None, :]
        return self._uncond

    @torch.inference_mode()
    def embed_image(self, image) -> torch.Tensor:
        """Image path or [H, W, 3] array → [1, 1, D] context."""
        arr = preprocess_image(image, self.vision_cfg.image_size)
        return self.vision(torch.from_numpy(arr).to(self.device))[:, None, :]

    def sample(self, context: torch.Tensor, x_T: torch.Tensor,
               scale: float = 3.0, ddim_steps: int = 100) -> torch.Tensor:
        """The core: DDIM with the CFG pair from ``x_T`` [1, C, h, w] on the
        image context → mel01 [1, 1, mel_bins, frames] in [0, 1]."""
        return self.t2a.sample_core(context, self.uncond, x_T, scale,
                                    ddim_steps, "ddim")

    def img2audio(self, image, seed: int = 55, scale: float = 3.0,
                  ddim_steps: int = 100):
        """→ ``(wav [T], sample_rate)`` as numpy, with the reference's
        defaults (audio-chatgpt.py:232); without a vocoder the mel
        [frames, mel_bins] in its place. The initial noise comes from a
        generator seeded with ``seed``."""
        cfg = self.t2a.cfg
        ctx = self.embed_image(image)
        h, w = cfg.latent_hw
        gen = torch.Generator(self.device).manual_seed(seed)
        x_T = torch.randn((1, cfg.unet.in_channels, h, w), generator=gen,
                          device=self.device)
        mel01 = self.sample(ctx, x_T, scale, ddim_steps)[:, 0]
        if self.t2a.vocoder is None:
            return mel01[0].T.cpu().numpy(), cfg.sample_rate
        return (self.t2a.vocoder.vocode(mel01)[0].cpu().numpy(),
                cfg.sample_rate)

    def __call__(self, image_path: str):
        return self.img2audio(image_path)
