"""1-D convolution blocks in NCW layout.

Counterpart of ``audiogpt_tpu/ops/conv.py``. The submodule and parameter
names follow the flax scopes (``Conv1d`` wraps a ``Conv_0``; the transposed
conv holds its weight directly), so JAX parameters map on mechanically
(``utils/jax_params.py``). Weight norm is folded before loading, as on the
JAX serving path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pad(kernel_size: int, dilation: int = 1) -> int:
    """torch get_padding: SAME padding for a stride-1 dilated conv."""
    return (kernel_size * dilation - dilation) // 2


def pad_same(x: torch.Tensor, kernel_size: int, stride: int,
             dims: int = 1) -> torch.Tensor:
    """lax's SAME padding of a stride-``stride`` window ``kernel_size`` on
    each of the last ``dims`` axes of ``x``: ``max((⌈n/s⌉ − 1)·s + k − n,
    0)`` in all on an axis, the odd one after (torch's ``padding="same"``
    refuses a stride)."""
    pads = []
    for n in reversed(x.shape[x.ndim - dims:]):     # F.pad: last axis first
        total = max((-(-n // stride) - 1) * stride + kernel_size - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Conv1d(nn.Module):
    """1-D conv on x [B, C, T] with explicit symmetric padding (``None`` =
    SAME for stride 1), as the JAX ``Conv1d`` (``ops/conv.py:24-53``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1,
                 padding: int | None = None, use_bias: bool = True):
        super().__init__()
        pad = same_pad(kernel_size, dilation) if padding is None else padding
        self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size,
                                stride=stride, padding=pad,
                                dilation=dilation, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class ConvTranspose1d(nn.Module):
    """Transposed 1-D conv matching torch ConvTranspose1d(k, s, padding=p):
    out_len = (in_len - 1)·s − 2p + k, on x [B, C, T]. The weight is torch's
    ``[in, out, W]``; JAX's ``[W, out, in]`` maps onto it by a transpose, no
    flip. The JAX package's polyphase form (``impl='phase'``) was a TPU
    compile workaround; this is the native transposed conv."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.randn(in_channels, features, kernel_size) * 0.01)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight, self.bias,
                                  stride=self.stride, padding=self.padding)


class FlaxConvTranspose1d(nn.Module):
    """flax ``nn.ConvTranspose(features, (k,), strides=(s,),
    padding="SAME")`` on x [B, C, T] → [B, features, T·s]: ``lax``'s SAME
    padding of a transposed conv, ``k + s − 2`` in all, split as
    ``lax._conv_transpose_padding`` splits it. flax applies its
    ``[W, in, out]`` kernel unflipped to the zero-stuffed input; the weight
    here is torch's ``[in, out, W]``, which is that kernel flipped in time
    (``utils/jax_params.py`` lays it out)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int):
        super().__init__()
        k, s = kernel_size, stride
        total = k + s - 2
        self.pad_lo = k - 1 if s > k - 1 else -(-total // 2)
        self.pad_hi = total - self.pad_lo
        self.stride = s
        self.weight = nn.Parameter(
            torch.randn(in_channels, features, kernel_size) * 0.01)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.pad_lo == self.pad_hi:
            return F.conv_transpose1d(x, self.weight, self.bias,
                                      stride=self.stride,
                                      padding=k - 1 - self.pad_lo)
        # padding 0 pads the stuffed input by k − 1 on each side: crop (or
        # zero-extend) each end to the SAME split, then add the bias
        y = F.conv_transpose1d(x, self.weight, stride=self.stride)
        y = F.pad(y, (self.pad_lo - (k - 1), self.pad_hi - (k - 1)))
        return y + self.bias[:, None]
