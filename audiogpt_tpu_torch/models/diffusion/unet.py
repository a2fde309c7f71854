"""Latent-diffusion UNet with cross-attention, NCHW.

Counterpart of ``audiogpt_tpu/models/diffusion/unet.py`` (the reference's
``UNetModel``, ``ldm/modules/diffusionmodules/openaimodel.py:413``, with
``SpatialTransformer`` cross-attention). Defaults match
``txt2audio_args.yaml``: 320 channels, ch_mult (1, 2), 2 res blocks,
attention at ds 1 and 2, 8 heads, context 1024. Submodules carry the flax
scope names. The level-0 self-attention (Tq·Tk ≥ 256²) runs the flash
kernel on the card through ``ops.attention``. ``use_checkpoint`` (JAX's
default, ``nn.remat`` at ``unet.py:199-203``) recomputes each ResBlock and
SpatialTransformer in the backward; it acts only when grad is enabled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from audiogpt_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (1, 2)
    channel_mult: Sequence[int] = (1, 2)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int | None = 1024
    use_checkpoint: bool = True


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """[N] → [N, dim] f32; cos-first ordering (diffusionmodules/util.py:151)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm(min(32, C)) computed in f32 (util.py:214). The UNet uses
    eps 1e-5; the VAE's ``Normalize`` uses 1e-6."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(min(32, channels), channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # f32 statistics and f32 affine parameters (bf16-rounded ones under
        # the engine's bf16 mode, as flax's f32 GroupNorm takes them)
        gn = self.GroupNorm_0
        return F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                            gn.bias.float(), gn.eps).to(x.dtype)


def _linear_f32(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.float(), layer.bias.float())


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


def zero_init(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


class ResBlock(nn.Module):
    """openaimodel ResBlock with additive timestep conditioning."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm32(channels)
        self.in_conv = conv3x3(channels, out_channels)
        self.emb_proj = nn.Linear(emb_dim, out_channels)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = zero_init(conv3x3(out_channels, out_channels))
        self.skip = (nn.Conv2d(channels, out_channels, 1)
                     if channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        kv_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, self.dim_head)

        out = attention(split(self.to_q(x)), split(self.to_k(ctx)),
                        split(self.to_v(ctx)))
        return self.to_out(out.reshape(x.shape[0], x.shape[1], -1))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj = nn.Linear(dim, dim * mult * 2)
        self.out = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(a * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int | None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.ff = GEGLUFeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int | None):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm32(channels)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim))
        self.proj_out = zero_init(nn.Conv2d(inner, channels, 1))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        t = self.proj_in(self.norm(x))
        inner = t.shape[1]
        t = t.permute(0, 2, 3, 1).reshape(b, h * w, inner)   # tokens (h, w)
        for d in range(self.depth):
            t = getattr(self, f"block_{d}")(t, context)
        t = t.reshape(b, h, w, inner).permute(0, 3, 1, 2)
        return self.proj_out(t) + x


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNetModel(nn.Module):
    """x [B, C_in, H, W], t [B], context [B, L, context_dim] →
    [B, C_out, H, W]."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        self.time_embed_0 = nn.Linear(mc, ted)
        self.time_embed_2 = nn.Linear(ted, ted)
        self.in_conv = conv3x3(cfg.in_channels, mc)

        def attn(ch: int) -> SpatialTransformer:
            return SpatialTransformer(ch, cfg.num_heads, ch // cfg.num_heads,
                                      cfg.transformer_depth, cfg.context_dim)

        # the forward pass is the JAX package's loop; the constructor walks
        # the same loop to size each block
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_{i}_res",
                                ResBlock(ch, mult * mc, ted))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self.add_module(f"down_{level}_{i}_attn", attn(ch))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch))
                chans.append(ch)
                ds *= 2
        self.mid_res1 = ResBlock(ch, ch, ted)
        self.mid_attn = attn(ch)
        self.mid_res2 = ResBlock(ch, ch, ted)
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}_res",
                                ResBlock(ch + chans.pop(), mult * mc, ted))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self.add_module(f"up_{level}_{i}_attn", attn(ch))
                if level and i == cfg.num_res_blocks:
                    self.add_module(f"up_{level}_us", Upsample(ch))
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = zero_init(conv3x3(ch, cfg.out_channels))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        # the sinusoid stays f32 through both projections (with bf16
        # parameters too, as flax promotes them), then takes x's dtype
        emb = timestep_embedding(t, cfg.model_channels)
        emb = _linear_f32(self.time_embed_0, emb)
        emb = _linear_f32(self.time_embed_2, F.silu(emb)).to(x.dtype)
        if context is not None:
            context = context.to(x.dtype)

        remat = cfg.use_checkpoint and torch.is_grad_enabled()

        def run(mod, h, cond):
            # nn.remat's counterpart: keep only the block's inputs and
            # recompute its inside in the backward. The block's parameters
            # are inputs too, so the recompute sees the tensors the forward
            # saw: under a caller's functional_call (the trainer's bf16
            # copies) the module's own are back by then
            if remat:
                names, params = zip(*mod.named_parameters())

                def call(h, cond, *params):
                    return torch.func.functional_call(
                        mod, dict(zip(names, params)), (h, cond))

                return checkpoint(call, h, cond, *params, use_reentrant=False)
            return mod(h, cond)

        def res(name, h):
            return run(getattr(self, name), h, emb)

        def block(name, h):
            mod = getattr(self, name, None)
            return h if mod is None else run(mod, h, context)

        h = self.in_conv(x)
        hs = [h]
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = res(f"down_{level}_{i}_res", h)
                h = block(f"down_{level}_{i}_attn", h)
                hs.append(h)
            if level != len(cfg.channel_mult) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
                hs.append(h)
        h = res("mid_res2", block("mid_attn", res("mid_res1", h)))
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=1)
                h = res(f"up_{level}_{i}_res", h)
                h = block(f"up_{level}_{i}_attn", h)
                if level and i == cfg.num_res_blocks:
                    h = getattr(self, f"up_{level}_us")(h)
        return self.out_conv(F.silu(self.out_norm(h)))
