"""GPT-2-class causal LM: the T2I tool's MagicPrompt prompt refiner.

Counterpart of ``audiogpt_tpu/models/textenc/gpt2.py:31-214``. The
reference's T2I tool runs a GPT-2 (``Gustavosta/MagicPrompt-Stable-
Diffusion``) over the user prompt before Stable Diffusion
(``audio-chatgpt.py:112-125``: ``pipeline("text-generation", ...)`` →
``generated_text``). :class:`GPT2LM` is the pre-LN transformer with the
input embedding tied to the head, explicit ``pos_ids`` (left-padded
prompts count positions from their first real token) and ``gelu`` with
the tanh approximation (HF's ``gelu_new``); its submodules carry the flax
scope names, so a ``gpt2``-family tree from ``import_ckpt`` loads through
``load_jax_params``.

:func:`greedy_generate` decodes one prompt greedily on a left-padded
prompt bucket of the dyadic ladder, as JAX's one compiled ``lax.scan``
program does: the prefill runs ``ops/attention.py`` ``attention(
is_causal=True, kv_mask=...)`` over the bucket (it reaches the flash
kernel where ``flash_takes`` lets it: Tq·Tk ≥ 256², a bucket of 256 or
more; causal masking is top-left in the kernel and bottom-right in the
plain path, which agree at Tq = Tk) and writes each layer's keys and
values into a static :class:`KVCache`; each decode step then runs on the
cache with the dense causal-and-padding mask. The ``lax.scan`` becomes a
Python loop over static shapes that runs all ``max_new`` steps (a row that
has emitted EOS keeps feeding EOS) and never syncs with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.engines.base import on_device, resolve_device, seeded
from audiogpt_tpu_torch.ops.attention import KVCache, attention


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    width: int = 768
    layers: int = 12
    heads: int = 12
    ln_eps: float = 1e-5
    eos_id: int = 50256

    @classmethod
    def from_tree(cls, tree: Mapping) -> "GPT2Config":
        """The config of a ``gpt2``-family tree: the vocabulary, positions,
        width and depth from its shapes; a head of 64 (every GPT-2 size's)
        and the last id as EOS (GPT-2's ``<|endoftext|>``)."""
        p = tree.get("params", tree)
        vocab, width = np.asarray(p["wte"]["embedding"]).shape
        return cls(vocab_size=vocab,
                   n_positions=np.asarray(p["wpe"]).shape[0], width=width,
                   layers=sum(1 for k in p if k[:1] == "h" and k[1:].isdigit()),
                   heads=max(width // 64, 1), eos_id=vocab - 1)


class _Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        d = cfg.width
        self.ln_1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.c_attn = nn.Linear(d, 3 * d)
        self.c_proj = nn.Linear(d, d)
        self.ln_2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.c_fc = nn.Linear(d, 4 * d)
        self.mlp_proj = nn.Linear(4 * d, d)

    def forward(self, x: torch.Tensor, cache: KVCache | None = None,
                kv_valid: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        h = self.ln_1(x)
        b, t = h.shape[:2]
        q, k, v = (u.reshape(b, t, cfg.heads, cfg.width // cfg.heads)
                   for u in self.c_attn(h).split(cfg.width, dim=-1))
        if cache is not None and cache.index > 0:
            # a decode step: the cache with the causal-and-padding mask
            cache.update(k, v)
            kpos = torch.arange(cache.k.shape[1], device=x.device)
            qpos = cache.index - t + torch.arange(t, device=x.device)
            mask = (kpos[None, :] <= qpos[:, None])[None, None]
            if kv_valid is not None:
                mask = mask & (kv_valid[:, None, None, :] > 0)
            a = attention(q, cache.k, cache.v, mask=mask)
        else:
            # the prefill (or a run without a cache): causal over the
            # prompt, its left padding masked as keys
            if cache is not None:
                cache.update(k, v)
            km = None if kv_valid is None else kv_valid[:, :t]
            a = attention(q, k, v, is_causal=True, kv_mask=km)
        x = x + self.c_proj(a.reshape(b, t, cfg.width))
        h = self.ln_2(x)
        return x + self.mlp_proj(F.gelu(self.c_fc(h), approximate="tanh"))


class GPT2LM(nn.Module):
    """tokens [B, t] → logits [B, t, vocab] (tied head: x · wteᵀ)."""

    def __init__(self, cfg: GPT2Config = GPT2Config()):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.width)
        self.wpe = nn.Parameter(torch.randn(cfg.n_positions, cfg.width)
                                * 0.02)
        for i in range(cfg.layers):
            self.add_module(f"h{i}", _Block(cfg))
        self.ln_f = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)

    def forward(self, tokens: torch.Tensor,
                pos_ids: torch.Tensor | None = None,
                caches: list[KVCache] | None = None,
                kv_valid: torch.Tensor | None = None) -> torch.Tensor:
        """``pos_ids`` [B, t]: explicit positions (default 0..t−1);
        ``caches``: one :class:`KVCache` a layer, written in place (an
        empty one takes the prefill); ``kv_valid`` [B, cache length or t]:
        1 for a real key, 0 for left padding."""
        if pos_ids is None:
            pos_ids = torch.arange(tokens.shape[1],
                                   device=tokens.device)[None]
        x = self.wte(tokens) + self.wpe[pos_ids]
        for i in range(self.cfg.layers):
            x = getattr(self, f"h{i}")(
                x, None if caches is None else caches[i], kv_valid)
        return self.ln_f(x) @ self.wte.weight.T


def bucket_prompt(prompt_ids: list[int], eos_id: int, min_bucket: int = 8
                  ) -> tuple[np.ndarray, np.ndarray]:
    """One prompt LEFT-padded (with EOS) onto the dyadic ladder from
    ``min_bucket`` → (tokens [1, L], valid [1, L], 1 = real)."""
    n = max(len(prompt_ids), 1)
    L = min_bucket
    while L < n:
        L *= 2
    toks = np.full((1, L), eos_id, np.int64)
    val = np.zeros((1, L), np.int64)
    toks[0, L - len(prompt_ids):] = prompt_ids
    val[0, L - len(prompt_ids):] = 1
    return toks, val


@torch.inference_mode()
def generate_tokens(model: GPT2LM, tokens: torch.Tensor,
                    valid: torch.Tensor, max_new: int) -> torch.Tensor:
    """tokens [B, L] left-padded (pads carry EOS), valid [B, L] → the
    greedy continuation [B, max_new] (EOS after a row stops), on the
    tokens' device, without a host sync (JAX's ``_generate_fn``)."""
    cfg = model.cfg
    b, L = tokens.shape
    dtype = next(model.parameters()).dtype
    kv_valid = torch.cat([valid, torch.ones(b, max_new, dtype=valid.dtype,
                                            device=valid.device)], dim=1)
    pos_ids = (valid.cumsum(1) - 1).clamp_min(0)
    caches = [KVCache.create(b, L + max_new, cfg.heads,
                             cfg.width // cfg.heads, dtype=dtype,
                             device=tokens.device)
              for _ in range(cfg.layers)]
    logits = model(tokens, pos_ids, caches, kv_valid)
    last = logits[:, -1].argmax(-1)
    plen = valid.sum(1)
    done = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    out = []
    for i in range(max_new):
        tok = torch.where(done, torch.full_like(last, cfg.eos_id), last)
        logits = model(tok[:, None], (plen + i)[:, None], caches, kv_valid)
        last = logits[:, -1].argmax(-1)
        done = done | (tok == cfg.eos_id)
        out.append(tok)
    return torch.stack(out, 1)


def greedy_generate(model: GPT2LM, prompt_ids: list[int],
                    max_new: int = 40, min_bucket: int = 8) -> list[int]:
    """One prompt → its greedy continuation ids, up to the first EOS; the
    prompt is left-padded onto its bucket, so each (bucket, max_new) pair
    has one set of shapes."""
    toks, val = bucket_prompt(prompt_ids, model.cfg.eos_id, min_bucket)
    dev = next(model.parameters()).device
    out = generate_tokens(model, torch.from_numpy(toks).to(dev),
                          torch.from_numpy(val).to(dev), max_new)
    ids = []
    for t in out[0].tolist():
        if t == model.cfg.eos_id:
            break
        ids.append(t)
    return ids


class MagicPromptRefiner:
    """user prompt → a Stable-Diffusion-flavoured prompt, the reference's
    ``text_refine`` slot (``audio-chatgpt.py:112-125``: the HF pipeline's
    default greedy decode, ``generated_text`` = prompt + continuation).

    ``params``: a ``gpt2``-family tree (``import_ckpt``; numpy leaves) or
    ``None`` for a seeded random init; ``codec``: a GPT-2 ``ByteBPE``
    (``text/bpe.py`` ``load_bpe_dir``; MagicPrompt checkpoint dirs carry
    their vocab) or any object with ``encode`` / ``decode``. Without a
    codec the prompt comes back unrefined, with a warning.
    ``device=None`` is the card, and raises without one."""

    def __init__(self, cfg: GPT2Config | None = None,
                 params: Mapping | None = None, codec=None,
                 max_new_tokens: int = 40, rng_seed: int = 0,
                 device: str | torch.device | None = None):
        self.cfg = cfg or GPT2Config()
        self.device = resolve_device(device)
        self.model = on_device(seeded(rng_seed, lambda: GPT2LM(self.cfg)),
                               self.device, params)
        self.codec = codec
        self.max_new_tokens = max_new_tokens

    def __call__(self, text: str) -> str:
        if self.codec is None:
            from audiogpt_tpu_torch.text.bpe import warn_fallback

            warn_fallback("MagicPromptRefiner",
                          "no GPT-2 codec wired: returning the prompt "
                          "unrefined")
            return text
        ids = self.codec.encode(text)
        if not ids:
            return text
        cont = greedy_generate(self.model, ids, self.max_new_tokens)
        return (text + self.codec.decode(cont)).strip()
