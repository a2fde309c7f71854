"""Fused anti-aliased snake: the Hopper kernel ``csrc/snake_aa.cu`` and its
plain PyTorch version.

Counterpart of ``audiogpt_tpu/ops/snake_aa.py``: BigVGAN's
``upsample2x → snake(β) → downsample2x`` (``alias_free_torch/act.py`` around
``activations.py:SnakeBeta``). The plain version is that literal chain, with
the kaiser-sinc FIRs as depthwise (``groups=C``) convolutions; the kernel
computes the same function in one pass without the 2× intermediate. The
filter design lives here, beside the kernel whose taps it fixes. The
kernel has no backward: no recipe of the JAX package trains BigVGAN
(``train/tasks/vocoder_gan.py:26`` trains HiFi-GAN), so a CUDA call that
would need a gradient raises (:func:`needs_grad`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from audiogpt_tpu_torch.ops import _build


@functools.lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass (julius.lowpass formulation, as used by
    alias_free_torch/filter.py), float32."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)  # symmetric (periodic=False)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        f = np.zeros(kernel_size)
    else:
        f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
        f = f / f.sum()
    return f.astype(np.float32)


def _taps(ratio: int, kernel_size: int | None, x: torch.Tensor) -> torch.Tensor:
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    f = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k)
    return torch.from_numpy(f).to(device=x.device, dtype=x.dtype)


def upsample1d(x: torch.Tensor, ratio: int = 2,
               kernel_size: int | None = None) -> torch.Tensor:
    """Anti-aliased ratio× upsampling of x [B, C, T] (UpSample1d: replicate
    pad, depthwise transposed conv with the kaiser-sinc taps × ratio, crop)."""
    taps = _taps(ratio, kernel_size, x)
    k, c = taps.numel(), x.shape[1]
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, taps.expand(c, 1, k), stride=ratio,
                                   groups=c)
    return y[..., pad_left: y.shape[-1] - pad_right]


def downsample1d(x: torch.Tensor, ratio: int = 2,
                 kernel_size: int | None = None) -> torch.Tensor:
    """Anti-aliased ratio× downsampling of x [B, C, T] (DownSample1d:
    replicate pad, depthwise strided conv with the kaiser-sinc taps)."""
    taps = _taps(ratio, kernel_size, x)
    k, c = taps.numel(), x.shape[1]
    pad_left = k // 2 - int(k % 2 == 0)
    pad_right = k // 2
    x = F.pad(x, (pad_left, pad_right), mode="replicate")
    return F.conv1d(x, taps.expand(c, 1, k), stride=ratio, groups=c)


def snake_aa_reference(x: torch.Tensor, alpha: torch.Tensor,
                       beta: torch.Tensor) -> torch.Tensor:
    """Plain version: the literal up2× → snake → down2× chain, in f32 (f64
    for an f64 input), returned in x's dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    a = alpha.to(dt)[None, :, None]
    inv_b = 1.0 / (beta.to(dt)[None, :, None] + 1e-9)
    u = upsample1d(xf, 2)
    u = u + inv_b * torch.sin(u * a) ** 2
    return downsample1d(u, 2).to(x.dtype)


_ENTRY = {torch.float32: "snake_aa_f32", torch.bfloat16: "snake_aa_bf16"}


def needs_grad(x: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> bool:
    """Whether autograd would need the gradient of this call: grad mode is
    on and x, α or β requires grad. The kernel refuses such a call."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, alpha, beta))


def snake_aa(x: torch.Tensor, alpha: torch.Tensor,
             beta: torch.Tensor) -> torch.Tensor:
    """x [B, C, T] (f32 or bf16), α and β [C] after the exp → [B, C, T] in
    x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises, also when autograd would need its gradient
    (:func:`needs_grad`): the kernel has none, and falling back to the
    plain version would hide that."""
    if x.device.type == "cpu":
        return snake_aa_reference(x, alpha, beta)
    if not x.is_cuda:
        raise ValueError(f"snake_aa: x on {x.device}")
    if needs_grad(x, alpha, beta):
        raise RuntimeError("snake_aa: the CUDA kernel has no backward (no "
                           "recipe trains BigVGAN); call it under "
                           "torch.no_grad() or on tensors without grad")
    if x.dtype not in _ENTRY:
        raise TypeError(f"snake_aa: the kernel takes f32 or bf16, not {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"snake_aa: x must be contiguous [B, C, T], got "
                         f"{tuple(x.shape)}")
    b, c, t = x.shape
    if alpha.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"snake_aa: alpha {tuple(alpha.shape)} / beta "
                         f"{tuple(beta.shape)} for {c} channels")
    if alpha.device != x.device or beta.device != x.device:
        raise ValueError("snake_aa: alpha/beta on another device than x")
    a = alpha.to(torch.float32).contiguous()
    bt = beta.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    name = _ENTRY[x.dtype]
    lib = _build.library()
    # the C entry launches on the calling thread's current device: make
    # x's card current, and hand it that card's current stream
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, name)(x.data_ptr(), a.data_ptr(), bt.data_ptr(),
                                 out.data_ptr(), b, c, t, stream)
    _build.check(err, name)
    _build.count_launch(snake_aa, x.device.index, stream,
                        x.dtype == torch.bfloat16)
    return out


#: launches of the CUDA kernel in this process (the main path's evidence),
#: of both entries and of the bf16 entry alone, by card and by stream
#: (``_build.count_launch``)
_build.reset_counts(snake_aa)
