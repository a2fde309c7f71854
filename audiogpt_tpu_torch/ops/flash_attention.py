"""Blockwise (flash) attention: the Hopper kernel ``csrc/flash_attention.cu``
and its plain PyTorch version.

Counterpart of ``audiogpt_tpu/ops/flash_attention.py``. Both versions follow
the Pallas kernel's semantics: scale ``D^-0.5``, an optional key-padding mask
``[B, Tk]`` (> 0 = valid), causal masking aligned top-left (key ``j`` visible
to query ``i`` when ``j <= i``), and 0 for a query row with no valid key.
Forward only: serving needs no gradient.
"""

from __future__ import annotations

import torch

from audiogpt_tpu_torch.ops import _build


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_mask: torch.Tensor | None = None,
                              causal: bool = False) -> torch.Tensor:
    """Plain version: the full score matrix, masked, softmaxed. → [B,Tq,H,D]."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    valid = torch.ones(q.shape[0], 1, tq, tk, dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        valid = valid & (kv_mask[:, None, None, :] > 0)
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None]
        cols = torch.arange(tk, device=q.device)[None, :]
        valid = valid & (cols <= rows)
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(valid.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor | None = None,
                    causal: bool = False) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D], kv_mask [B, Tk] → [B, Tq, H, D].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (f32, contiguous, D <= 128) or raises."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, causal)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("flash_attention: the kernel takes float32 q/k/v")
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d > 128:
        raise ValueError(f"flash_attention: head dim {d} > 128")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q/k/v must be contiguous")
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (b, tk) or kv_mask.device != q.device:
            raise ValueError(f"flash_attention: kv_mask {tuple(kv_mask.shape)}"
                             f" on {kv_mask.device}")
        mask = kv_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    err = _build.library().flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b, tq, tk, h, d, d ** -0.5, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_f32")
    flash_attention.launches += 1
    return out


#: launches of the CUDA kernel in this process (the main path's evidence)
flash_attention.launches = 0
