"""Training metrics: epoch meters and the metrics log.

Counterpart of ``audiogpt_tpu/train/metrics.py``. ``AvgrageMeter``
(``NeuralSeq/utils/__init__.py:28``) skips non-finite values;
``metrics.jsonl`` in the work dir gets one line per log event with the keys
of JAX's (``step``, ``t``, ``prefix`` and the scalars); TensorBoard scalars
go beside it when ``torch.utils.tensorboard`` imports. Only rank 0 of a
process group writes (``is_main``; JAX: process 0, ``metrics.py:59``).
``log_mel_figure`` writes the validation mel figure of the TTS recipes
(``save_valid_result``), drawn with PIL: the card's machine has no
matplotlib.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Mapping


class AvgMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.avg, self.sum, self.cnt = 0.0, 0.0, 0

    def update(self, val: float, n: int = 1):
        if not math.isfinite(val):
            return  # reference skips NaN losses in meters (base_task.py:137)
        self.sum += val * n
        self.cnt += n
        self.avg = self.sum / max(self.cnt, 1)


class MeterBank:
    def __init__(self):
        self._meters: dict[str, AvgMeter] = {}

    def update(self, metrics: Mapping[str, Any], n: int = 1):
        """``metrics``: numbers or 0-d tensors (read with one copy to the
        host for all of them)."""
        vals = _floats(metrics)
        for k, v in vals.items():
            self._meters.setdefault(k, AvgMeter()).update(v, n)

    def averages(self) -> dict[str, float]:
        return {k: m.avg for k, m in self._meters.items()}

    def reset(self):
        for m in self._meters.values():
            m.reset()


def _floats(metrics: Mapping[str, Any]) -> dict[str, float]:
    import torch

    keys = list(metrics)
    tensors = [k for k in keys if isinstance(metrics[k], torch.Tensor)]
    out = {k: float(metrics[k]) for k in keys if k not in tensors}
    if tensors:
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in tensors]).tolist()
        out.update(zip(tensors, vals))
    return {k: out[k] for k in keys}


class MetricsLogger:
    """JSONL + optional TensorBoard, rank 0 only: on another rank every
    method does nothing."""

    def __init__(self, work_dir: str, use_tensorboard: bool = True):
        from audiogpt_tpu_torch.parallel.mesh import is_main

        self.work_dir = work_dir
        self.is_main = is_main()
        self._f = None
        self._tb = None
        if not self.is_main:
            return
        os.makedirs(work_dir, exist_ok=True)
        self._f = open(os.path.join(work_dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(work_dir, "tb"))

    def log(self, step: int, metrics: Mapping[str, Any], prefix: str = "tr"):
        if not self.is_main:
            return
        scalars = _floats(metrics)
        self._f.write(json.dumps(
            {"step": step, "t": time.time(), "prefix": prefix, **scalars})
            + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)

    def log_mel_figure(self, step: int, name: str, mel, gt=None) -> None:
        """The validation mel plot (``save_valid_result`` →
        ``utils/plot.spec_to_figure`` in the reference; JAX's
        ``log_mel_figure``): ``work_dir/figures/{name}_{step}.png`` and,
        when TensorBoard is on, an image. ``mel`` / ``gt``: [frames,
        n_mels] arrays. JAX's image: the frames of the ground truth, two
        frames of the lowest value and the prediction's, in one colour
        scale, mel bin 0 at the bottom; drawn here with PIL (jet colours,
        4 pixels a frame and a bin). JAX's title calls the panels top and
        bottom; they lie side by side, and this title says so."""
        if not self.is_main:
            return
        import numpy as np
        from PIL import Image, ImageDraw

        from audiogpt_tpu_torch.engines.analysis import _jet

        data = np.asarray(mel, np.float32)
        if gt is not None:
            gt = np.asarray(gt, np.float32)
            gap = np.full((2, data.shape[1]), min(data.min(), gt.min()))
            data = np.concatenate([gt, gap, data], axis=0)
        lo, hi = float(data.min()), float(data.max())
        rgb = _jet((data.T[::-1] - lo) / max(hi - lo, 1e-12))
        pic = Image.fromarray(rgb).resize((4 * rgb.shape[1],
                                           4 * rgb.shape[0]), Image.NEAREST)
        canvas = Image.new("RGB", (pic.width, pic.height + 20), "white")
        canvas.paste(pic, (0, 20))
        ImageDraw.Draw(canvas).text(
            (4, 4), f"{name} @ {step}" + (" (left: gt, right: pred)"
                                          if gt is not None else ""),
            fill="black")
        fig_dir = os.path.join(self.work_dir, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        canvas.save(os.path.join(fig_dir, f"{name}_{step}.png"))
        if self._tb is not None:
            self._tb.add_image(f"val/{name}", np.asarray(canvas), step,
                               dataformats="HWC")

    def close(self):
        if not self.is_main:
            return
        self._f.close()
        if self._tb is not None:
            self._tb.close()
