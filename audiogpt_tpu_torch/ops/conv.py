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


class Conv1d(nn.Module):
    """Stride-1 1-D conv with bias on x [B, C, T], with explicit symmetric
    padding (``None`` = SAME)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dilation: int = 1, padding: int | None = None):
        super().__init__()
        pad = same_pad(kernel_size, dilation) if padding is None else padding
        self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size,
                                padding=pad, dilation=dilation)

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
