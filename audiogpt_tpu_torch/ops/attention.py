"""Multi-head attention: the shared op of the UNet, the text towers and
whisper, and the decode's KV cache.

Counterpart of ``audiogpt_tpu/ops/attention.py:22-74``. Its dispatch rule
is JAX's wherever the kernel takes the call: a long sequence (Tq·Tk ≥ 256²)
with no dense mask goes to the flash kernel when the tensors are on the
card and :func:`flash_takes` accepts their dtypes and head dim (at most
160, the widest head of any path: the SD UNet's ds-4 level; the Pallas
kernel takes any). Everything else is the plain product and softmax below.
:class:`KVCache` is the static-length cache of autoregressive
decode: its shape stays fixed for the whole decode.
"""

from __future__ import annotations

import torch

from audiogpt_tpu_torch.ops.flash_attention import (flash_attention,
                                                    kernel_takes)

NEG_INF = -1e30
#: an attention goes to the flash kernel from this many (query, key) pairs
FLASH_MIN_PAIRS = 256 * 256


class KVCache:
    """Static-length key/value cache ``[B, max_len, H, D]`` in the compute
    dtype; ``index`` (a host int) is the next write position. ``update``
    writes in place, so the tensors keep their storage for the whole
    decode."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, index: int = 0):
        self.k, self.v, self.index = k, v, index

    @classmethod
    def create(cls, batch: int, max_len: int, heads: int, dim: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cpu") -> "KVCache":
        return cls(torch.zeros(batch, max_len, heads, dim, dtype=dtype,
                               device=device),
                   torch.zeros(batch, max_len, heads, dim, dtype=dtype,
                               device=device))

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write ``[B, t, H, D]`` at ``index`` and advance it by t."""
        t = k_new.shape[1]
        if self.index + t > self.k.shape[1]:
            raise ValueError(f"KV cache of {self.k.shape[1]} positions: "
                             f"cannot write {t} at {self.index}")
        self.k[:, self.index:self.index + t] = k_new
        self.v[:, self.index:self.index + t] = v_new
        self.index += t
        return self


def flash_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor | None = None) -> bool:
    """Whether the flash kernel takes this call, wherever the tensors lie:
    no dense mask, Tq·Tk ≥ ``FLASH_MIN_PAIRS``, and dtypes and a head dim
    that the kernel takes (:func:`kernel_takes`)."""
    return (mask is None
            and q.shape[1] * k.shape[1] >= FLASH_MIN_PAIRS
            and kernel_takes(q, k, v))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None, is_causal: bool = False,
              kv_mask: torch.Tensor | None = None,
              use_flash: bool | None = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D] → [B, Tq, H, D].

    ``mask`` broadcasts to [B, H, Tq, Tk] (True = keep); ``kv_mask`` [B, Tk]
    (1 = valid) is a key-padding mask, which the flash path takes. With
    ``use_flash=None`` a call on the card goes to the kernel where
    :func:`flash_takes` says it may; ``use_flash=True`` forces the kernel,
    which raises for a shape it does not take. The kernel gets contiguous
    q/k/v (a split of a fused projection is a strided view): a copy only
    where one is needed."""
    if use_flash is None:
        use_flash = q.is_cuda and flash_takes(q, k, v, mask)
    if use_flash and mask is None:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               kv_mask=kv_mask, causal=is_causal)
    if kv_mask is not None:
        km = kv_mask[:, None, None, :] > 0
        mask = km if mask is None else (mask & km)
    # f32 logits whatever the input dtype (the JAX einsum's
    # preferred_element_type)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if is_causal:
        tq, tk = q.shape[1], k.shape[1]
        causal = torch.ones(tq, tk, dtype=torch.bool,
                            device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~causal, NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
