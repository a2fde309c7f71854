"""BLIP-base image captioner (the agent's "Get Photo Description" tool).

Counterpart of ``audiogpt_tpu/models/caption/blip.py`` (the reference's
``BlipForConditionalGeneration`` from ``Salesforce/blip-image-captioning-
base``, greedy ``generate`` on a 384 × 384 image):

  * a ViT-B/16 vision tower (fused-qkv pre-LN blocks, post-LN) whose 577
    patch states are the decoder's cross-attention source. On the card each
    block's self-attention (577² pairs, 12 heads of 64) takes the flash
    kernel; its q/k/v are strided views of the fused projection, which
    ``ops/attention.py`` copies contiguous;
  * a BERT-style post-LN text decoder (self-attention over a static
    ``KVCache`` under a valid-length mask, cross-attention on image K/V
    projected once per image) with a dense + GELU + LN head; both
    attentions stay plain (a mask; 577 pairs a token);
  * greedy decode as a Python loop over ``max_tokens`` steps with the JAX
    scan's rule: once a row has emitted EOS it keeps feeding EOS.

Submodules and parameters carry the flax scope names, so
``utils/jax_params.py`` maps a JAX tree mechanically. Images are
``[B, H, W, 3]`` as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.ops.attention import KVCache, attention

# BLIP uses the OpenAI-CLIP image normalisation constants
BLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
BLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class BlipVisionConfig:
    image_size: int = 384
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072

    @property
    def seq_len(self) -> int:
        n = self.image_size // self.patch_size
        return n * n + 1


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524          # bert-base-uncased + [DEC]/[ENC]
    width: int = 768
    layers: int = 12
    heads: int = 8
    mlp_dim: int = 3072
    max_position: int = 512
    encoder_width: int = 768         # cross-attention source width
    bos_id: int = 30522              # [DEC]
    eos_id: int = 102                # [SEP]: the caption's stop token
    pad_id: int = 0
    ln_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    vision: BlipVisionConfig = BlipVisionConfig()
    text: BlipTextConfig = BlipTextConfig()


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], heads, t.shape[2] // heads)


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------


class _VisionBlock(nn.Module):
    """Pre-LN block with BLIP's fused qkv projection."""

    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_split(u, self.heads)
                   for u in self.qkv(self.ln_1(x)).chunk(3, dim=-1))
        x = x + self.proj(attention(q, k, v).flatten(2))
        return x + self.fc2(F.gelu(self.fc1(self.ln_2(x))))


class BlipVisionEncoder(nn.Module):
    """images [B, H, W, 3] (BLIP-normalised) → patch states
    [B, N + 1, width]."""

    def __init__(self, cfg: BlipVisionConfig = BlipVisionConfig()):
        super().__init__()
        self.cfg = cfg
        p, w = cfg.patch_size, cfg.width
        self.patch_embed = nn.Conv2d(3, w, p, stride=p)
        # the flax initialisers' scales
        self.class_embedding = nn.Parameter(0.02 * torch.randn(w))
        self.position_embedding = nn.Parameter(
            0.02 * torch.randn(cfg.seq_len, w))
        for i in range(cfg.layers):
            self.add_module(f"block{i}",
                            _VisionBlock(w, cfg.heads, cfg.mlp_dim))
        self.post_ln = nn.LayerNorm(w, eps=1e-5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images.permute(0, 3, 1, 2))     # [B, W, n, n]
        x = x.flatten(2).transpose(1, 2)                      # [B, n·n, W]
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding
        for i in range(self.cfg.layers):
            x = getattr(self, f"block{i}")(x)
        return self.post_ln(x)


# ---------------------------------------------------------------------------
# Text decoder (BERT-style post-LN with cross-attention)
# ---------------------------------------------------------------------------


class _TextLayer(nn.Module):
    def __init__(self, cfg: BlipTextConfig):
        super().__init__()
        self.heads = cfg.heads
        d, eps = cfg.width, cfg.ln_eps
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.attn_ln = nn.LayerNorm(d, eps=eps)
        self.xq = nn.Linear(d, d)
        self.xk = nn.Linear(cfg.encoder_width, d)
        self.xv = nn.Linear(cfg.encoder_width, d)
        self.x_out = nn.Linear(d, d)
        self.x_ln = nn.LayerNorm(d, eps=eps)
        self.inter = nn.Linear(d, cfg.mlp_dim)
        self.out = nn.Linear(cfg.mlp_dim, d)
        self.out_ln = nn.LayerNorm(d, eps=eps)

    def cross_kv(self, img: torch.Tensor):
        """Image states → their (k, v) [B, N, H, D], projected once."""
        return _split(self.xk(img), self.heads), _split(self.xv(img),
                                                        self.heads)

    def forward(self, x: torch.Tensor, cross_kv,
                cache: KVCache | None = None) -> torch.Tensor:
        """With ``cache`` this chunk's K/V are written to it and attention
        spans its filled positions (one token a step in the greedy loop);
        without, causal self-attention over ``x``."""
        q, k, v = (_split(f(x), self.heads) for f in (self.q, self.k, self.v))
        if cache is not None:
            cache.update(k, v)
            pos = torch.arange(cache.k.shape[1], device=x.device)
            a = attention(q, cache.k, cache.v,
                          mask=(pos < cache.index)[None, None, None])
        else:
            a = attention(q, k, v, is_causal=True)
        x = self.attn_ln(x + self.attn_out(a.flatten(2)))
        a = attention(_split(self.xq(x), self.heads), *cross_kv)
        x = self.x_ln(x + self.x_out(a.flatten(2)))
        return self.out_ln(x + self.out(F.gelu(self.inter(x))))


class BlipTextDecoder(nn.Module):
    def __init__(self, cfg: BlipTextConfig):
        super().__init__()
        self.cfg = cfg
        self.word_emb = nn.Embedding(cfg.vocab_size, cfg.width)
        self.pos_emb = nn.Parameter(
            0.02 * torch.randn(cfg.max_position, cfg.width))
        self.emb_ln = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", _TextLayer(cfg))
        # LM head: transform (dense + GELU + LN), then the decoder matrix
        self.head_dense = nn.Linear(cfg.width, cfg.width)
        self.head_ln = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.head_out = nn.Linear(cfg.width, cfg.vocab_size)

    def layers(self) -> list[_TextLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def cross_kvs(self, img: torch.Tensor) -> list:
        return [layer.cross_kv(img) for layer in self.layers()]

    def forward(self, tokens: torch.Tensor, img: torch.Tensor | None = None,
                pos_offset: int = 0, caches: list[KVCache] | None = None,
                cross_kvs: list | None = None) -> torch.Tensor:
        """tokens [B, t] (and image states [B, N, D], or their
        ``cross_kvs``) → logits [B, t, vocab]. With ``caches`` (one
        :class:`KVCache` a layer) the step's K/V are appended to them."""
        if cross_kvs is None:
            cross_kvs = self.cross_kvs(img)
        x = self.word_emb(tokens) \
            + self.pos_emb[pos_offset:pos_offset + tokens.shape[1]]
        x = self.emb_ln(x)
        for i, layer in enumerate(self.layers()):
            x = layer(x, cross_kvs[i], None if caches is None else caches[i])
        x = F.gelu(self.head_dense(x))
        return self.head_out(self.head_ln(x))


class BlipCaptioner(nn.Module):
    """HF ``BlipForConditionalGeneration``'s captioning path."""

    def __init__(self, cfg: BlipConfig = BlipConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision = BlipVisionEncoder(cfg.vision)
        self.decoder = BlipTextDecoder(cfg.text)

    def forward(self, images: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, t, vocab]."""
        return self.decoder(tokens, img=self.vision(images))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.vision(images)

    def cross_kvs(self, img: torch.Tensor) -> list:
        return self.decoder.cross_kvs(img)

    def decode_step(self, tokens: torch.Tensor, cross_kvs: list,
                    pos_offset: int, caches: list[KVCache]) -> torch.Tensor:
        return self.decoder(tokens, pos_offset=pos_offset, caches=caches,
                            cross_kvs=cross_kvs)


# ---------------------------------------------------------------------------
# Greedy caption
# ---------------------------------------------------------------------------


@torch.inference_mode()
def greedy_caption(model: BlipCaptioner, images: torch.Tensor,
                   max_tokens: int = 24) -> torch.Tensor:
    """images [B, H, W, 3] on the model's device → tokens
    [B, 1 + max_tokens] (BOS, then the caption, EOS-padded after its stop),
    HF ``generate``'s greedy decode from ``[BOS]``. The JAX scan's steps:
    a row that has fed EOS keeps feeding it. The last step's logits pick no
    token, so that step is not run."""
    cfg = model.cfg.text
    b = images.shape[0]
    img = model.encode_image(images)
    cross = model.cross_kvs(img)
    caches = [KVCache.create(b, 1 + max_tokens, cfg.heads,
                             cfg.width // cfg.heads, img.dtype, img.device)
              for _ in range(cfg.layers)]
    prompt = torch.full((b, 1), cfg.bos_id, dtype=torch.long,
                        device=images.device)
    last = model.decode_step(prompt, cross, 0, caches)[:, -1].argmax(-1)
    done = torch.zeros(b, dtype=torch.bool, device=images.device)
    toks = []
    for i in range(max_tokens):
        tok = last.masked_fill(done, cfg.eos_id)
        toks.append(tok)
        if i + 1 < max_tokens:
            last = model.decode_step(tok[:, None], cross, 1 + i,
                                     caches)[:, -1].argmax(-1)
        done = done | (tok == cfg.eos_id)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


def preprocess_image(path_or_array, image_size: int = 384) -> np.ndarray:
    """An image path → PIL load, bicubic resize to (size, size), /255; an
    array is taken as it is (/255 when its values exceed 1.5). Then the
    BLIP normalisation → float32 [1, H, W, 3] (HF ``BlipImageProcessor``:
    a direct resize, no centre crop)."""
    if isinstance(path_or_array, str):
        from PIL import Image

        img = Image.open(path_or_array).convert("RGB")
        img = img.resize((image_size, image_size), Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0
    else:
        arr = np.asarray(path_or_array, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
    arr = (arr - BLIP_MEAN) / BLIP_STD
    return arr[None].astype(np.float32)
