"""The card's peak rates, the FLOP count of a training step, and MFU.

Counterpart of ``audiogpt_tpu/utils/flops.py``, and the one home of the
card's peaks in this repository: the trainer, ``chip_smoke.py`` and
``train_flops.py`` import them from here.

The peaks are NVIDIA's H100 SXM data sheet, dense rates: bf16 on the
tensor cores, TF32 on the tensor cores, f32 on the FMA units, and the HBM
bandwidth. MFU divides a run's FLOP/s by the peak of the dtype it computes
in (TF32 where PyTorch lets matmuls or cuDNN use it); JAX's divides by the
chip's bf16 peak for every program.

JAX's ``xla_flops`` (XLA's cost analysis of the compiled program) has no
counterpart: :func:`count_flops` stands in for it, ``FlopCounterMode``'s
count of aten's matmuls and convolutions plus what the flash kernel
reports of its own launches, which no aten op shows. Elementwise work is
not counted. :func:`hifigan_flops` is JAX's analytic count, copied.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

#: HBM bytes per second
HBM_BYTES_PER_S = 3.35e12
#: dense FLOP/s: bf16 and TF32 on the tensor cores, f32 on the FMA units
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
#: device-name substring → the peaks of that card
PEAK_FLOPS = {"H100": {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS,
                       "f32": F32_FLOPS}}


def peak_flops(device: torch.device, dtype: torch.dtype) -> float | None:
    """The card's dense peak for a run in ``dtype``: bf16, else TF32 where
    PyTorch lets matmuls or cuDNN use it, else f32. None for the CPU or an
    unknown card."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    peaks = next((p for key, p in PEAK_FLOPS.items() if key in name), None)
    if peaks is None:
        return None
    if dtype == torch.bfloat16:
        return peaks["bf16"]
    tf32 = torch.backends.cuda.matmul.allow_tf32 or \
        torch.backends.cudnn.allow_tf32
    return peaks["tf32" if tf32 else "f32"]


def count_flops(fn: Callable[[], Any]) -> tuple[Any, float]:
    """``fn()`` under ``FlopCounterMode`` → (its result, its FLOPs): aten's
    count plus the flash kernel's own launches in the call."""
    from torch.utils.flop_counter import FlopCounterMode

    from audiogpt_tpu_torch.ops.flash_attention import flash_attention

    kernel = flash_attention.flops
    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, float(counter.get_total_flops()
                      + flash_attention.flops - kernel)


def hifigan_flops(cfg: Any, frames: int, batch: int = 1) -> float:
    """Analytic conv FLOPs (2·K·Cin·Cout·T_out a conv) of a HiFi-GAN
    forward (``models/vocoder/hifigan.py``)."""
    total = 0.0
    n_mels = cfg.in_channels
    ch = cfg.upsample_initial_channel
    t = frames
    total += 2 * 7 * n_mels * ch * t                       # conv_pre (k=7)
    for r, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        cin, cout = ch, ch // 2
        t_out = t * r
        total += 2 * k * cin * cout * t_out                # up conv
        for rk, dils in zip(cfg.resblock_kernel_sizes,
                            cfg.resblock_dilation_sizes):
            n_convs = 2 * len(dils) if cfg.resblock == "1" else len(dils)
            total += n_convs * 2 * rk * cout * cout * t_out
        ch, t = cout, t_out
    total += 2 * 7 * ch * 1 * t                            # conv_post
    return float(total * batch)


def mfu(flops: float | None, wall_s: float, device: torch.device,
        dtype: torch.dtype = torch.float32) -> float | None:
    """FLOP/s ÷ the card's peak for ``dtype``; None when either is
    unknown."""
    if not flops or wall_s <= 0:
        return None
    peak = peak_flops(device, dtype)
    if peak is None:
        return None
    return flops / wall_s / peak
