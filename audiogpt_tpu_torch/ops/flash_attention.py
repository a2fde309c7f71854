"""Blockwise (flash) attention: the Hopper kernels
``csrc/flash_attention_sm90_f32.cu`` (f32: 3xTF32 on ``wgmma``) and
``csrc/flash_attention_sm90.cu`` (bf16: ``wgmma``), both fed by TMA, and
their plain PyTorch version.

Counterpart of ``audiogpt_tpu/ops/flash_attention.py``. Both versions follow
the Pallas kernel's semantics: scale ``D^-0.5``, an optional key-padding mask
``[B, Tk]`` (> 0 = valid), causal masking aligned top-left (key ``j`` visible
to query ``i`` when ``j <= i``), and 0 for a query row with no valid key.
f32 and bf16: the logits and the softmax are f32 whatever the input type,
and for bf16 the probabilities are rounded to bf16 before the product with
``v`` (``_flash_kernel:76``, ``_reference:173``).

:class:`FlashAttention` makes it differentiable, as JAX's ``custom_vjp``
(``flash_attention.py:177-200``) does: the forward is the kernel on the
card (the plain version on the CPU), the backward recomputes the plain
version and takes its gradient (``_flash_core_bwd``, an XLA recompute in
JAX, not a Pallas kernel). It is the gradient of the port's own forward,
so it differs from JAX's only where the two forwards do (a row with no
valid key; causal masking with Tq != Tk).
"""

from __future__ import annotations

import ctypes

import torch

from audiogpt_tpu_torch.ops import _build

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
#: each entry's block shape (query rows a block: 64, 128 or 192, one to
#: three consumer warpgroups, the kernel's own choice per call; resident
#: blocks per SM), which :func:`launch_grid` reads
_OCCUPANCY = {torch.float32: "flash_attention_occupancy",
              torch.bfloat16: "flash_attention_bf16_occupancy"}


def _dtypes_taken(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    return q.dtype in _ENTRY and k.dtype == q.dtype and v.dtype == q.dtype


#: the widest head dim the kernel is compiled for (the SD UNet's ds-4 level)
MAX_HEAD_DIM = 160


def _head_dim_taken(q: torch.Tensor) -> bool:
    d = q.shape[-1]
    return d <= MAX_HEAD_DIM and d * q.element_size() % 16 == 0


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel's dtypes and head dim take q/k/v, wherever they
    lie: all f32 or all bf16, a head dim of at most 160 whose rows are a
    multiple of 16 bytes. :func:`flash_attention` raises where this is
    false; ``ops/attention.py``'s dispatch builds on it."""
    return _dtypes_taken(q, k, v) and _head_dim_taken(q)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_mask: torch.Tensor | None = None,
                              causal: bool = False) -> torch.Tensor:
    """Plain version: the full score matrix, masked, softmaxed. → [B,Tq,H,D].

    f32 logits and softmax; the probabilities are rounded to the input type
    and multiplied with ``v`` in f32 (a no-op rounding for f32 inputs)."""
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
    probs = probs.to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """The forward of :func:`flash_attention`; the backward recomputes
    :func:`flash_attention_reference` and takes its gradient. q, k, v and
    the key mask are saved only when q, k or v needs a gradient, so a
    forward under ``no_grad`` or on tensors without grad keeps nothing."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        out = _forward(q, k, v, kv_mask, causal)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, kv_mask)
            ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, kv_mask = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip((q, k, v), need)]
            out = flash_attention_reference(*inputs, kv_mask, ctx.causal)
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], grad_out))
        return (*(next(grads) if n else None for n in need), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor | None = None,
                    causal: bool = False) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D], kv_mask [B, Tk] → [B, Tq, H, D];
    differentiable in q, k and v (:class:`FlashAttention`).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (f32 or bf16, contiguous, D <= 160 with rows of a multiple of 16 bytes)
    or raises."""
    return FlashAttention.apply(q, k, v, kv_mask, causal)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             kv_mask: torch.Tensor | None, causal: bool) -> torch.Tensor:
    """The forward alone: the plain version for CPU tensors, else the
    kernel."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, causal)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}")
    if not _dtypes_taken(q, k, v):
        raise TypeError(f"flash_attention: the kernel takes f32 or bf16 "
                        f"q/k/v of one type, not {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape != (b, tk, h, d) or v.shape != k.shape or tq == 0 or tk == 0:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not _head_dim_taken(q):
        raise ValueError(f"flash_attention: head dim {d} ({q.dtype}): the "
                         f"kernel copies rows of a multiple of 16 bytes, "
                         f"at most {MAX_HEAD_DIM} elements")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention: q/k/v must be contiguous and "
                         "16-byte aligned")
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (b, tk) or kv_mask.device != q.device:
            raise ValueError(f"flash_attention: kv_mask {tuple(kv_mask.shape)}"
                             f" on {kv_mask.device}")
        mask = kv_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    name = _ENTRY[q.dtype]
    lib = _build.library()
    # the C entry launches on the calling thread's current device: make
    # q's card current, and hand it that card's current stream
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, tq, tk, h, d, d ** -0.5, int(causal), stream)
    _build.check(err, name)
    _build.count_launch(flash_attention, q.device.index, stream,
                        q.dtype == torch.bfloat16, 4 * b * tq * tk * h * d)
    return out


#: launches of the CUDA kernel in this process (the main path's evidence),
#: of both entries and of the bf16 entry alone, by card and by stream
#: (``_build.count_launch``); and the FLOPs of those launches
#: (4·B·Tq·Tk·H·D each, the Pallas call's ``cost_estimate``), which
#: ``FlopCounterMode`` cannot see: the trainer adds them to its count
_build.reset_counts(flash_attention)
flash_attention.flops = 0


def launch_grid(q: torch.Tensor) -> dict:
    """The kernel's grid for q [B, Tq, H, D] on its card: query rows a
    block, blocks, resident blocks per SM and the waves they make there."""
    b, tq, h, d = q.shape
    n, rows = ctypes.c_int(0), ctypes.c_int(0)
    name = _OCCUPANCY[q.dtype]
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), name)(
            b, tq, h, d, ctypes.byref(rows), ctypes.byref(n))
    _build.check(err, name)
    blocks = -(-tq // rows.value) * h * b
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return {"block_q": rows.value, "blocks": blocks,
            "blocks_per_sm": n.value, "sms": sms,
            "waves": blocks / (n.value * sms) if n.value else None}
