"""Checkpoint store over ``torch.save`` files.

Counterpart of ``audiogpt_tpu/train/checkpoint.py`` (an orbax
``CheckpointManager``). The reference's semantics, kept:

* atomic writes: each file goes to ``.part`` and is published by
  ``os.replace`` (``pl_utils.py:722-737``);
* retention as the orbax manager's options in JAX give it: with a
  ``monitor``, the ``num_keep`` best checkpoints by that metric
  (``mode`` min or max; ties keep the later step) plus every checkpoint
  saved without metrics (orbax ``BestN`` with
  ``keep_checkpoints_without_metrics``); without one, the ``num_keep``
  newest (``LatestN``);
* resume from the newest step; ``best_step`` the best by the metric, the
  newest without a monitor;
* in a process group, rank 0 writes and prunes and every rank reads (the
  trainer puts a barrier before a restore).

Layout: ``<work_dir>/ckpt/<step>.pt`` holds the state; ``<step>.json``
beside it holds the metrics and the EMA groups of that state, so listing,
retention and ``saved_ema_groups`` read no tensor. The state is what the
trainer gives: plain containers of tensors and numbers, loaded back with
``weights_only``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

import torch

_STEP = re.compile(r"^(\d+)\.pt$")


def _write_atomic(path: str, write) -> None:
    part = path + ".part"
    write(part)
    os.replace(part, path)


class CheckpointStore:
    def __init__(self, work_dir: str, num_keep: int = 3,
                 monitor: str | None = "total_loss", mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: 'min' or 'max'")
        self.directory = os.path.join(os.path.abspath(work_dir), "ckpt")
        self.num_keep, self.monitor, self.mode = num_keep, monitor, mode
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, ext: str) -> str:
        return os.path.join(self.directory, f"{step}.{ext}")

    def _meta(self, step: int) -> dict:
        try:
            with open(self._path(step, "json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def save(self, step: int, state: Mapping[str, Any],
             metrics: Mapping[str, float] | None = None) -> None:
        """Write the checkpoint of ``step`` (rank 0 only; the other ranks
        return at once)."""
        from audiogpt_tpu_torch.parallel.mesh import is_main

        if not is_main():
            return
        meta = {"metrics": dict(metrics) if metrics else None,
                "ema_groups": sorted(state.get("ema") or {})}

        def write_meta(p):
            with open(p, "w") as f:
                json.dump(meta, f)

        _write_atomic(self._path(step, "json"), write_meta)
        _write_atomic(self._path(step, "pt"),
                      lambda p: torch.save(dict(state), p))
        self._remove_old()

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _STEP.match(name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _ranked(self, steps: list[int]) -> list[int]:
        """Steps with the monitored metric, worst first, ties by step
        (orbax sorts by the metric, stably, reversed for 'min')."""
        scored = [(s, m[self.monitor]) for s in steps
                  if (m := self._meta(s).get("metrics")) is not None]
        return [s for s, _ in sorted(scored, key=lambda sm: sm[1],
                                     reverse=self.mode == "min")]

    def best_step(self) -> int | None:
        if not self.monitor:
            return self.latest_step()
        ranked = self._ranked(self.all_steps())
        return ranked[-1] if ranked else None

    def _remove_old(self) -> None:
        steps = self.all_steps()
        if self.num_keep is None or len(steps) <= self.num_keep:
            return
        if not self.num_keep:
            keep = set()
        elif self.monitor:
            keep = set(self._ranked(steps)[-self.num_keep:])
            keep |= {s for s in steps
                     if self._meta(s).get("metrics") is None}
        else:
            keep = set(steps[-self.num_keep:])
        for s in steps:
            if s not in keep:
                for ext in ("pt", "json"):
                    try:
                        os.remove(self._path(s, ext))
                    except FileNotFoundError:
                        pass

    def restore(self, step: int | None = None,
                map_location: str | torch.device = "cpu") -> dict:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step, "pt"), map_location=map_location,
                          weights_only=True)

    def saved_ema_groups(self, step: int) -> set[str]:
        """The ``state['ema']`` group names of the checkpoint at ``step``:
        empty for one written without EMA shadows (the trainer then seeds
        them from the restored params)."""
        return set(self._meta(step).get("ema_groups") or ())
