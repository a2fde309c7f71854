"""Training metrics: epoch meters and the metrics log.

Counterpart of ``audiogpt_tpu/train/metrics.py``. ``AvgrageMeter``
(``NeuralSeq/utils/__init__.py:28``) skips non-finite values;
``metrics.jsonl`` in the work dir gets one line per log event with the keys
of JAX's (``step``, ``t``, ``prefix`` and the scalars); TensorBoard scalars
go beside it when ``torch.utils.tensorboard`` imports. One process writes.
The validation mel figure (``log_mel_figure``) comes with the first recipe
that draws one (``fs2``).
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
    """JSONL + optional TensorBoard."""

    def __init__(self, work_dir: str, use_tensorboard: bool = True):
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self._f = open(os.path.join(work_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(work_dir, "tb"))

    def log(self, step: int, metrics: Mapping[str, Any], prefix: str = "tr"):
        scalars = _floats(metrics)
        self._f.write(json.dumps(
            {"step": step, "t": time.time(), "prefix": prefix, **scalars})
            + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
