"""The cross-rank reductions of data-parallel training — the collectives
that XLA inserts into the JAX step, written out.

Under ``jit`` the JAX step sees the whole sharded batch: every ``sum`` and
``mean`` of a loss runs over the global batch, and a permutation or a B×B
score matrix reaches across its rows. The port's trainer gives each rank
its contiguous rows (``mesh.shard_batch``), so a loss that is to equal
JAX's reduces over ranks explicitly:

* :func:`global_sum` — the sum of a tensor over the ``data`` ranks (a
  numerator, a count, a squared norm; :func:`global_sums` several in one
  all-reduce, :func:`global_mean`, :func:`global_means` and
  :func:`global_l2` on top);
* :func:`gather_rows` — the rows of every rank in rank order (a batch-wide
  permutation, InfoNCE's B×B logits, the shortest length);
* :func:`local_rows` — this rank's rows of a tensor made for the global
  batch (a task's draws, made for the global batch from the step's seed
  and then cut).

Every rank then computes the same global loss. Both collectives are
autograd functions whose backward sums the incoming gradient over the
ranks, so after the trainer averages the ranks' parameter
gradients (one flat all-reduce a group) every parameter holds the
gradient of the global loss: a rank's own rows contribute D times through
the collective and are divided by D, and a term that reads the parameters
alone (no batch) contributes once on every rank.

With no bound mesh, or a ``data`` axis of size 1, each function is the
identity and launches nothing. A bound group that is missing or broken
raises in the collective: nothing quietly becomes a no-op.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _DataAxis:
    group = None        # the process group of the ``data`` axis
    size = 1
    rank = 0


_DATA = _DataAxis()


def bind(group, size: int, rank: int) -> None:
    """Reduce over ``group`` (``size`` ranks, this one ``rank``) from now
    on; ``size`` 1 makes every function the identity. The trainer binds
    its mesh's ``data`` axis (``mesh.bind_data_axis``)."""
    if size > 1 and group is None:
        raise ValueError(f"a data axis of {size} ranks needs a process group")
    _DATA.group, _DATA.size, _DATA.rank = group, int(size), int(rank)


def world() -> int:
    """The number of data-parallel ranks (1 without a bound mesh)."""
    return _DATA.size


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, group=_DATA.group)
    return out


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


def _scatter_rows(x: torch.Tensor) -> torch.Tensor:
    """[b, ...] → [D·b, ...] zeros with ``x`` at this rank's rows."""
    full = x.new_zeros((x.shape[0] * _DATA.size, *x.shape[1:]))
    full[_DATA.rank * x.shape[0]:(_DATA.rank + 1) * x.shape[0]] = x.detach()
    return full


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # one all-reduce of zero-padded rows: any backend that reduces
        # (gloo takes CUDA tensors for all_reduce, not for all_gather), and
        # a sum with zeros is exact
        full = _scatter_rows(x)
        dist.all_reduce(full, group=_DATA.group)
        return full

    @staticmethod
    def backward(ctx, grad):
        return local_rows(_all_reduce(grad))


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ``data`` ranks (elementwise), the same on
    every rank; its backward sums the gradient over the ranks."""
    if _DATA.size == 1:
        return x
    return _GlobalSum.apply(x)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x`` over the global batch: every
    rank holds a tensor of the same shape (its rows of the batch)."""
    if _DATA.size == 1:
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * _DATA.size)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[b, ...] → [D·b, ...]: every rank's rows in rank order, the same on
    every rank; its backward sums the gradient over the ranks and keeps
    this rank's rows."""
    if _DATA.size == 1:
        return x
    return _GatherRows.apply(x)


def global_rows(n: int) -> int:
    """The global batch's row count when this rank holds ``n`` rows."""
    return n * _DATA.size


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows ``[r·b, (r+1)·b)`` of a tensor made for
    the global batch (b = its rows / D)."""
    if _DATA.size == 1:
        return x
    n = x.shape[0]
    if n % _DATA.size:
        raise ValueError(f"{n} rows do not split over {_DATA.size} ranks")
    b = n // _DATA.size
    return x[_DATA.rank * b:(_DATA.rank + 1) * b]


def global_sums(*xs: torch.Tensor) -> tuple:
    """Several 0-d sums (a numerator and its count, ...) each summed over
    the ranks, in one all-reduce; → them in order."""
    if _DATA.size == 1:
        return xs
    return tuple(global_sum(torch.stack([x.to(xs[0].dtype)
                                         for x in xs])).unbind())


def global_means(*xs: torch.Tensor) -> list:
    """:func:`global_mean` of each tensor, in one all-reduce."""
    if _DATA.size == 1:
        return [x.mean() for x in xs]
    sums = global_sums(*(x.sum() for x in xs))
    return [s / (x.numel() * _DATA.size) for s, x in zip(sums, xs)]


def global_l2(x: torch.Tensor) -> torch.Tensor:
    """The Frobenius norm of ``x`` over the global batch."""
    if _DATA.size == 1:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(global_sum(x.square().sum()))
