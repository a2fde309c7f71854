"""Training loop — counterpart of ``audiogpt_tpu/train/trainer.py``, on one
card or data-parallel over a process group (``parallel/``).

The reference's semantics that the JAX trainer keeps, kept here:

* gradient accumulation and global-norm clipping with optax's semantics
  (``train/optim.py``);
* the NaN guard: on a non-finite loss the gradients become zeros and the
  optimizer still steps (Adam's moments decay and the params move by
  momentum), ``nonfinite`` counts the event (``trainer.py:168-174``);
* LitEma weight shadows, ``e -= (1-d)(e-p)`` with ``d = min(decay,
  (n+1)/(10+n))`` and ``n`` the 1-based update count, so the first update
  uses 2/11 (``ldm/modules/ema.py``);
* ``step`` advances once per batch, after the last param group;
* validation every ``val_check_interval`` steps on the EMA params with a
  fixed generator (JAX: ``PRNGKey(0)``), a sanity validation at step 0;
* keep-N and best checkpoints, resume from the newest, a final checkpoint
  with the ``1e30`` sentinel; SIGTERM / SIGINT stop the loop gracefully and
  checkpoint;
* ``steps_per_sec``, ``grad_norm`` and ``mfu`` in the log: the FLOPs of a
  step are counted once per batch shape (``utils/flops.py``
  ``count_flops``: ``FlopCounterMode`` plus the flash kernel's own
  launches; JAX: XLA's cost analysis, ``trainer.py:209-240``) and divided
  by the card's peak for the task's ``compute_dtype``.

Data parallelism keeps JAX's global-batch semantics (``trainer.py:73``,
``:272``, ``:334``): every rank runs the same loader with the same seed and
so holds the global batch; ``shard_batch`` cuts its rows, and its draws
are made for the global batch from the step's shared seed and cut the
same way (each task's ``draws``, ``parallel/reduce.py`` ``local_rows``).
A loss reduces over ranks through ``global_sum`` / ``gather_rows``, so
every rank computes the global loss; each group's gradients are averaged
over the ``data`` ranks in one flat all-reduce (an explicit all-reduce:
the gradients come from ``torch.autograd.grad``, which DDP's hooks never
see), and ``finite``, ``grad_norm``, the update and the EMA come out
identical on every rank. Validation runs on every rank (its reductions are
collective) with the global batch's ``n``; only rank 0 logs and writes
checkpoints, and every rank waits at a barrier before it restores. The
stop flag is all-reduced each step, so every rank stops at the same step.
``mfu`` is each rank's FLOPs over its card's peak (JAX: the global FLOPs
over ``mesh.size`` × peak). Left out, as a TPU workaround: buffer
donation. A batch goes to the device once, pinned and ``non_blocking``.

A :class:`Task` owns its modules (built on its device), the loss of each
optimized group and each group's :class:`OptimConfig`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Any, Callable, Iterable, Mapping, Protocol

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from audiogpt_tpu_torch.engines.base import resolve_device
from audiogpt_tpu_torch.parallel.mesh import (axis_group, axis_size,
                                              bind_data_axis, make_mesh,
                                              replicate, shard_batch)
from audiogpt_tpu_torch.train.checkpoint import CheckpointStore
from audiogpt_tpu_torch.train.metrics import MeterBank, MetricsLogger
from audiogpt_tpu_torch.train.optim import (OptimConfig, global_norm,
                                            make_optimizer)
from audiogpt_tpu_torch.utils.flops import count_flops, mfu

class Task(Protocol):
    """A training recipe. ``modules`` maps every group that optimizes, and
    any other name (``frozen``), to its module; ``loss_fns`` maps each
    optimized group to ``loss(batch, generator) -> (loss, metrics)``, whose
    gradient is taken with respect to that group's parameters that
    require grad."""

    @property
    def modules(self) -> Mapping[str, nn.Module]: ...
    @property
    def loss_fns(self) -> Mapping[str, Callable]: ...
    @property
    def optim_cfgs(self) -> Mapping[str, OptimConfig]: ...


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    work_dir: str = "work_dir"
    max_updates: int = 1_000_000          # config_base.yaml max_updates
    val_check_interval: int = 2000
    num_sanity_val_steps: int = 2
    log_interval: int = 100
    num_ckpt_keep: int = 3
    monitor: str = "total_loss"
    seed: int = 1234
    use_tensorboard: bool = True


class Trainer:
    """``device=None`` is the card, and raises without one; the task's
    modules are moved there. ``mesh`` (default ``make_mesh()``: every rank
    of the process group on ``data``, or a one-process mesh without a
    group) is what the batches are sharded over and what the losses'
    reductions run on; the modules are broadcast from rank 0."""

    def __init__(self, task: Task, cfg: TrainerConfig | None = None,
                 device: str | torch.device | None = None, mesh=None):
        self.task = task
        self.cfg = cfg or TrainerConfig()
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        bind_data_axis(self.mesh)
        self.data_size = axis_size(self.mesh, "data")
        # the gradient all-reduce runs wherever a process group exists,
        # one rank included (its values are then the rank's own)
        self._grad_group = axis_group(self.mesh, "data") \
            if dist.is_initialized() else None
        #: time the gradient all-reduce of each step (CUDA events;
        #: ``comm_ms`` gets one entry a step)
        self.time_comm = False
        self.comm_ms: list[float] = []
        self._comm_events: list = []
        for module in task.modules.values():
            module.to(self.device)
            replicate(module, self.mesh)
        self.groups = list(task.loss_fns)
        self.named = {g: [(n, p) for n, p in
                          task.modules[g].named_parameters()
                          if p.requires_grad] for g in self.groups}
        self.params = {g: [p for _, p in self.named[g]] for g in self.groups}
        self.opt = {g: make_optimizer(task.optim_cfgs[g], self.params[g])
                    for g in self.groups}
        # weight-EMA shadows (reference LitEma, ddpm.py use_ema) for the
        # groups that ask for one, beside the live params
        self.ema = {g: [p.detach().clone() for p in self.params[g]]
                    for g in self.groups
                    if task.optim_cfgs[g].ema_decay > 0.0}
        self.step = 0
        self.logger = MetricsLogger(self.cfg.work_dir,
                                    self.cfg.use_tensorboard)
        self.store = CheckpointStore(self.cfg.work_dir, self.cfg.num_ckpt_keep,
                                     monitor=self.cfg.monitor)
        self.generator = torch.Generator(self.device)
        self._flops: dict[Any, float] = {}
        self._flops_window = 0.0

    # -- state ---------------------------------------------------------------
    def state(self) -> dict[str, Any]:
        """What a checkpoint holds: each optimized group's params, its
        optimizer state and EMA shadows, and the step. The frozen modules
        are the task's and are not written."""
        return {"params": {g: {n: p.detach() for n, p in self.named[g]}
                           for g in self.groups},
                "opt": {g: self.opt[g].state_dict() for g in self.groups},
                "ema": {g: {n: e for (n, _), e in zip(self.named[g], ema)}
                        for g, ema in self.ema.items()},
                "step": self.step}

    def restore_or_init(self) -> None:
        """Restore the newest checkpoint when there is one; else keep the
        state as built."""
        if dist.is_initialized():
            dist.barrier()      # rank 0's writes land before any rank reads
        latest = self.store.latest_step()
        if latest is not None:
            self._restore(latest)
            if self.logger.is_main:
                print(f"| resumed from step {latest}")

    @torch.no_grad()
    def _restore(self, step: int) -> None:
        """Load the checkpoint at ``step``. EMA-layout drift is tolerated,
        as ``_restore_compat`` tolerates it: shadows of a group the
        checkpoint has none for are seeded from its restored params (what
        LitEma does on construction); shadows it has for a group without
        EMA are ignored."""
        ck = self.store.restore(step, map_location=self.device)
        for g in self.groups:
            saved = ck["params"][g]
            names = [n for n, _ in self.named[g]]
            if sorted(saved) != sorted(names):
                raise ValueError(f"checkpoint {step}: params of {g!r} do not "
                                 f"match the task's")
            for n, p in self.named[g]:
                p.copy_(saved[n])
            self.opt[g].load_state_dict(ck["opt"][g])
        saved_ema = ck.get("ema") or {}
        for g, ema in self.ema.items():
            src = saved_ema.get(g)
            for (n, p), e in zip(self.named[g], ema):
                e.copy_(p if src is None else src[n])
        self.step = int(ck["step"])

    def save(self, metrics: Mapping[str, float] | None = None) -> None:
        self.store.save(self.step, self.state(), metrics=metrics)

    @contextlib.contextmanager
    def ema_scope(self):
        """The EMA-tracked groups' shadows swapped into their modules for
        the block (the reference validates and exports under
        ``ema_scope``, ddpm.py ``use_ema``)."""
        live = {g: [p.detach().clone() for p in self.params[g]]
                for g in self.ema}
        with torch.no_grad():
            for g, ema in self.ema.items():
                torch._foreach_copy_(self.params[g], ema)
        try:
            yield
        finally:
            with torch.no_grad():
                for g, saved in live.items():
                    torch._foreach_copy_(self.params[g], saved)

    # -- steps ---------------------------------------------------------------
    def _to_device(self, batch: Mapping[str, Any]) -> dict[str, Any]:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def train_step(self, group: str, batch: Mapping[str, Any],
                   seed: int) -> dict[str, torch.Tensor]:
        """One optimizer step of ``group`` on ``batch`` (on the device),
        its loss drawing from the generator seeded with ``seed``: forward,
        backward, the NaN guard, the update and the EMA."""
        cfg_g = self.task.optim_cfgs[group]
        params = self.params[group]
        self.generator.manual_seed(seed)
        loss, metrics = self.task.loss_fns[group](batch, self.generator)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            # zeros where the loss is not finite or a parameter got no
            # gradient: the update still decays the moments, as optax's
            # does (out of place: autograd may return an expanded view)
            finite = torch.isfinite(loss.detach())
            if self._grad_group is None:
                grads = [torch.zeros_like(p) if g is None
                         else torch.where(finite, g, 0.0)
                         for g, p in zip(grads, params)]
            else:
                grads = self._all_reduce_grads(grads, params, finite)
            norm = global_norm(grads)
            self.opt[group].step(grads)
            if group in self.ema:
                d = np.float32(cfg_g.ema_decay)
                if cfg_g.ema_warmup:
                    n = np.float32(self.step) + np.float32(1.0)
                    d = min(d, (n + np.float32(1.0)) / (np.float32(10.0) + n))
                torch._foreach_lerp_(self.ema[group], params,
                                     float(np.float32(1.0) - d))
        metrics = dict(metrics)
        metrics["grad_norm"] = norm
        metrics["nonfinite"] = 1.0 - finite.float()
        return metrics

    def _all_reduce_grads(self, grads, params, finite) -> list:
        """The ranks' mean of each gradient (zeros for an unused parameter,
        all zeros where the global loss is not finite), through one flat
        all-reduce a dtype; → views of the flat buffer."""
        out = [None] * len(params)
        by_dtype: dict[torch.dtype, list[int]] = {}
        for i, p in enumerate(params):
            by_dtype.setdefault(p.dtype, []).append(i)
        timed = self.time_comm and self.device.type == "cuda"
        for idx in by_dtype.values():
            flat = torch.cat([params[i].new_zeros(params[i].numel())
                              if grads[i] is None else grads[i].reshape(-1)
                              for i in idx])
            if timed:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            dist.all_reduce(flat, group=self._grad_group)
            if timed:
                end.record()
                self._comm_events.append((start, end))
            flat.masked_fill_(~finite, 0.0)
            if self.data_size > 1:
                flat.div_(self.data_size)
            for i, g in zip(idx, flat.split([params[i].numel()
                                             for i in idx])):
                out[i] = g.view_as(params[i])
        return out

    def _read_comm(self) -> None:
        """Move the finished all-reduce timings of the last step into
        ``comm_ms`` (the step's metrics were copied to the host: every
        event has completed)."""
        if self._comm_events:
            self.comm_ms.append(sum(s.elapsed_time(e)
                                    for s, e in self._comm_events))
            self._comm_events = []

    def _stop_requested(self, stop) -> bool:
        """The stop flag, any rank's (a MAX all-reduce each step), so every
        rank leaves the loop at the same step."""
        if not dist.is_initialized():
            return stop["flag"]
        dev = self.device if dist.get_backend() == "nccl" else "cpu"
        flag = torch.tensor(float(stop["flag"]), device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        stop["flag"] = bool(flag.item())
        return stop["flag"]

    def _run_step(self, group: str, batch: Mapping[str, Any],
                  seed: int) -> dict[str, torch.Tensor]:
        """``train_step``, with the step's FLOPs counted on the first batch
        of each shape (``FlopCounterMode``, plus the flash kernel's own
        count) and added to the log window's total after."""
        key = (group, tuple(sorted((k, tuple(getattr(v, "shape", ())),
                                    str(getattr(v, "dtype", type(v))))
                                   for k, v in batch.items())))
        if key not in self._flops:
            metrics, self._flops[key] = count_flops(
                lambda: self.train_step(group, batch, seed))
        else:
            metrics = self.train_step(group, batch, seed)
        self._flops_window += self._flops[key]
        return metrics

    def _val_metrics(self, batch, generator) -> dict:
        val_fn = getattr(self.task, "val_loss_fn", None)
        if val_fn is not None:
            return val_fn(batch, generator)[1]
        # default: the sum of all group losses
        total, metrics = 0.0, {}
        for g, fn in self.task.loss_fns.items():
            loss, m = fn(batch, generator)
            total = total + loss
            metrics.update({f"{g}_{k}": v for k, v in m.items()})
        metrics["total_loss"] = total
        return metrics

    def _visualize(self, batch) -> None:
        self.generator.manual_seed(0)
        try:
            figs = self.task.visualize(batch, self.generator)
            for name, (pred, gt) in figs.items():
                self.logger.log_mel_figure(
                    self.step, name, pred.float().cpu().numpy(),
                    None if gt is None else gt.float().cpu().numpy())
        except Exception as e:  # plots must never kill training (JAX's rule)
            if self.logger.is_main:
                print(f"| visualize failed: {e!r}")

    # -- loops ---------------------------------------------------------------
    def validate(self, val_batches: Iterable, max_batches: int | None = None
                 ) -> dict[str, float]:
        """Average metrics over ``val_batches`` on the EMA params, every
        batch drawing from the generator seeded with 0 and weighted by the
        global batch's ``n``; then a task with ``visualize(batch,
        generator) -> {name: (pred, gt | None)}`` draws its figures of the
        first batch (``MetricsLogger.log_mel_figure``; JAX's
        ``trainer.py:280-295``). Every rank runs it: the losses' reductions
        are collective."""
        bank = MeterBank()
        first = None
        with self.ema_scope(), torch.no_grad():
            for i, batch in enumerate(val_batches):
                if max_batches is not None and i >= max_batches:
                    break
                n = int(np.asarray(batch["weight"]).sum()) \
                    if "weight" in batch \
                    else next(iter(batch.values())).shape[0]
                batch = self._to_device(shard_batch(batch, self.mesh))
                first = batch if first is None else first
                self.generator.manual_seed(0)
                metrics = self._val_metrics(batch, self.generator)
                bank.update(metrics, n=max(n, 1))
            if first is not None and hasattr(self.task, "visualize"):
                self._visualize(first)
        avgs = bank.averages()
        if "total_loss" not in avgs and avgs:
            avgs["total_loss"] = sum(
                v for k, v in avgs.items() if k.endswith("loss"))
        return avgs

    def fit(self, train_batches: Iterable,
            val_batches_fn: Callable[[], Iterable] | None = None,
            max_updates: int | None = None) -> dict[str, Any]:
        cfg = self.cfg
        max_updates = max_updates if max_updates is not None \
            else cfg.max_updates
        self.restore_or_init()

        # Preemption handling (the reference has none): SIGTERM / SIGINT
        # request a graceful stop; the loop checkpoints and returns, so a
        # restarted job resumes at the same step.
        stop = {"flag": False}

        def request_stop(signum, frame):
            stop["flag"] = True

        old_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, request_stop)
        except ValueError:
            pass  # not the main thread: no handler
        try:
            self._loop(train_batches, val_batches_fn, max_updates, stop)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
        return self.state()

    def _loop(self, train_batches, val_batches_fn, max_updates,
              stop) -> None:
        cfg = self.cfg
        start_step = self.step
        rng = np.random.default_rng(cfg.seed + start_step)
        if val_batches_fn is not None and cfg.num_sanity_val_steps > 0 \
                and start_step == 0:
            sanity = self.validate(val_batches_fn(),
                                   max_batches=cfg.num_sanity_val_steps)
            self.logger.log(0, sanity, prefix="sanity")

        bank = MeterBank()
        t0 = time.time()
        for batch in train_batches:
            if self.step >= max_updates or self._stop_requested(stop):
                break
            batch = self._to_device(shard_batch(batch, self.mesh))
            batch.setdefault("step", self.step)
            # one seed a step, shared by its groups and the ranks (JAX: one
            # key a step)
            seed = int(rng.integers(2 ** 62))
            for group in self.groups:
                bank.update(self._run_step(group, batch, seed))
            self._read_comm()
            self.step += 1

            if self.step % cfg.log_interval == 0:
                avgs = bank.averages()
                elapsed = max(time.time() - t0, 1e-9)
                avgs["steps_per_sec"] = cfg.log_interval / elapsed
                util = mfu(self._flops_window, elapsed, self.device,
                           getattr(self.task, "compute_dtype",
                                   torch.float32))
                if util is not None:
                    avgs["mfu"] = util
                self._flops_window = 0.0
                self.logger.log(self.step, avgs, prefix="tr")
                bank.reset()
                t0 = time.time()

            if self.step % cfg.val_check_interval == 0:
                val_metrics = {}
                if val_batches_fn is not None:
                    val_metrics = self.validate(val_batches_fn())
                    self.logger.log(self.step, val_metrics, prefix="val")
                self.save({cfg.monitor: float(val_metrics.get(cfg.monitor,
                                                              0.0))})

        if self.step != start_step and \
                self.step % cfg.val_check_interval != 0:
            # large finite sentinel: never wins best-by-monitor, stays
            # JSON-safe
            self.save({cfg.monitor: 1e30})
        if stop["flag"] and self.logger.is_main:
            print(f"| graceful stop at step {self.step} (checkpoint saved)")
