"""Shared compute ops: attention, the flash and snake-AA kernels, convs."""

from audiogpt_tpu_torch.ops.attention import attention
from audiogpt_tpu_torch.ops.flash_attention import flash_attention
from audiogpt_tpu_torch.ops.snake_aa import snake_aa

__all__ = ["attention", "flash_attention", "snake_aa"]
