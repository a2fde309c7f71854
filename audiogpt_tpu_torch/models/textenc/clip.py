"""CLIP towers (vision + text) for image-conditioned audio generation.

Counterpart of ``audiogpt_tpu/models/textenc/clip.py:1-166`` (the reference's
``FrozenGlobalNormOpenCLIPEmbedder``, ``ldm/modules/encoders/modules.py:315``,
open_clip ViT-H-14): I2A conditions the LDM on the L2-normalised CLIP image
embedding as a length-1 context, with the normalised text embedding of
``""`` as the unconditional branch. Patch conv → pre-LN transformer
(quick-GELU) → ``ln_post`` → projection; the text tower is a causal pre-LN
transformer pooled at the EOT position.

Submodules and parameters carry the flax scope names (``patch_embed``,
``block{i}.in_proj``, ``class_embedding``, ``proj``, ...), so
``utils/jax_params.py`` maps a JAX tree mechanically. The vision tower takes
``[B, H, W, 3]`` as the JAX one does. Its 257 tokens at 224 px reach the
flash kernel in every block (257² ≥ 256², D = 1280 / 16 = 80); the q/k/v
split of the fused ``in_proj`` are strided views, which ``ops/attention.py``
makes contiguous for the kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from audiogpt_tpu_torch.ops.attention import attention

# open_clip image normalization constants
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14           # ViT-H-14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    embed_dim: int = 1024          # projected output dim

    @property
    def tokens(self) -> int:
        """Patches plus the class token."""
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 1024
    layers: int = 24
    heads: int = 16
    embed_dim: int = 1024


def _layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-5)


class ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.ln_1 = _layer_norm(width)
        self.in_proj = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = _layer_norm(width)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = (u.reshape(b, t, self.heads, d // self.heads)
                   for u in self.in_proj(self.ln_1(x)).chunk(3, dim=-1))
        a = attention(q, k, v, is_causal=self.causal)
        x = x + self.out_proj(a.reshape(b, t, d))
        h = self.mlp_fc(self.ln_2(x))
        return x + self.mlp_proj(quick_gelu(h))


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        p, w = cfg.patch_size, cfg.width
        self.patch_embed = nn.Conv2d(3, w, p, stride=p, bias=False)
        # the flax initialisers' scales
        self.class_embedding = nn.Parameter(0.02 * torch.randn(w))
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(cfg.tokens, w))
        self.ln_pre = _layer_norm(w)
        for i in range(cfg.layers):
            self.add_module(f"block{i}", ResidualBlock(w, cfg.heads))
        self.ln_post = _layer_norm(w)
        self.proj = nn.Parameter(w ** -0.5 * torch.randn(w, cfg.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] (CLIP-normalised) → L2-normalised
        [B, embed_dim]."""
        x = self.patch_embed(images.permute(0, 3, 1, 2))     # [B, W, n, n]
        x = x.flatten(2).transpose(1, 2)                      # [B, n·n, W]
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for i in range(self.cfg.layers):
            x = getattr(self, f"block{i}")(x)
        z = self.ln_post(x[:, 0]) @ self.proj
        return z / z.norm(dim=-1, keepdim=True)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(cfg.context_length, w))
        for i in range(cfg.layers):
            self.add_module(f"block{i}",
                            ResidualBlock(w, cfg.heads, causal=True))
        self.ln_final = _layer_norm(w)
        self.text_projection = nn.Parameter(
            w ** -0.5 * torch.randn(w, cfg.embed_dim))

    def forward(self, tokens: torch.Tensor,
                return_sequence: bool = False) -> torch.Tensor:
        """tokens [B, L] (EOT = the max id of a row) → L2-normalised
        [B, embed_dim]; ``return_sequence=True`` → the post-LN states
        [B, L, width] (StableDiffusion's cross-attention context)."""
        x = self.token_embedding(tokens) \
            + self.positional_embedding[: tokens.shape[1]]
        for i in range(self.cfg.layers):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_final(x)
        if return_sequence:
            return x
        x = x[torch.arange(x.shape[0], device=x.device),
              tokens.argmax(dim=-1)]
        z = x @ self.text_projection
        return z / z.norm(dim=-1, keepdim=True)


def _center_square(img, image_size: int) -> np.ndarray:
    """PIL image → its centre square resized to ``image_size`` (bicubic),
    as float32 [H, W, 3] in [0, 1]."""
    from PIL import Image

    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    img = img.resize((image_size, image_size), Image.BICUBIC)
    return np.asarray(img, np.float32) / 255.0


def preprocess_image(path_or_array, image_size: int = 224) -> np.ndarray:
    """Image path or array → centre crop, resize → CLIP normalisation →
    [1, H, W, 3]. An array already ``image_size`` square needs no PIL."""
    if isinstance(path_or_array, str):
        from PIL import Image

        arr = _center_square(Image.open(path_or_array).convert("RGB"),
                             image_size)
    else:
        arr = np.asarray(path_or_array, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.shape[:2] != (image_size, image_size):
            from PIL import Image

            arr = _center_square(
                Image.fromarray((arr * 255).astype(np.uint8)), image_size)
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr[None]
