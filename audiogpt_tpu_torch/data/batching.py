"""Length-aware batching onto a small ladder of static shapes.

Counterpart of ``audiogpt_tpu/data/batching.py``, copied (numpy only). The
reference batches by token count with dynamic per-batch padding
(``BaseDataset.ordered_indices`` at ``NeuralSeq/tasks/base_task.py:60``,
``batch_by_size`` at ``NeuralSeq/utils/__init__.py:89``). Here, as in the
JAX package, the same shuffle-then-stable-sort and token-budget grouping
run, and each batch is then padded up to a (batch, length) rung of a
:class:`BucketSpec`: a training run sees a handful of batch shapes, so the
step's kernels, their launch configurations and the allocator's blocks
repeat, and a later CUDA graph per shape is possible. ``EndlessSampler``
replaces ``EndlessDistributedSampler`` (``tasks/vocoder/dataset_utils.py``)
with epoch-seeded shuffling. The permutations are numpy's
``default_rng``, keyed as JAX's loader keys them, so both packages draw the
same batches from the same seed.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Iterator, Sequence

import numpy as np


def ordered_indices(sizes: Sequence[int], shuffle: bool = True,
                    seed: int | tuple | None = None) -> np.ndarray:
    """Random permutation then mergesort by size — equal-length items keep
    the random order (base_task.py:60-69)."""
    sizes = np.asarray(sizes)
    if not shuffle:
        return np.arange(len(sizes))
    idx = np.random.default_rng(seed).permutation(len(sizes))
    return idx[np.argsort(sizes[idx], kind="mergesort")]


def batch_by_size(
    indices: Sequence[int],
    num_tokens_fn: Callable[[int], int],
    max_tokens: int | None = None,
    max_sentences: int | None = None,
) -> list[list[int]]:
    """Token-budget batching with the reference's split rule
    (utils/__init__.py:89-143) at a required batch-size multiple of 1: a
    batch closes when adding one more item would exceed ``max_tokens`` (at
    the running max item length) or ``max_sentences``."""
    max_tokens = max_tokens if max_tokens is not None else sys.maxsize
    max_sentences = max_sentences if max_sentences is not None else sys.maxsize

    batches: list[list[int]] = []
    batch: list[int] = []
    sample_len = 0
    for idx in indices:
        idx = int(idx)
        n = num_tokens_fn(idx)
        sample_len = max(sample_len, n)
        if sample_len > max_tokens:
            raise ValueError(
                f"item {idx} has {sample_len} tokens > max_tokens={max_tokens}")
        if batch and (len(batch) == max_sentences
                      or (len(batch) + 1) * sample_len > max_tokens):
            batches.append(batch)
            batch, sample_len = [], n
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static-shape ladder for (batch, length). Lengths round up to the next
    rung; batch pads up to the batch bucket with zero-weight dummy rows."""

    length_buckets: tuple[int, ...]
    batch_buckets: tuple[int, ...]

    def round_len(self, n: int) -> int:
        for b in self.length_buckets:
            if n <= b:
                return b
        return self.length_buckets[-1]

    def round_batch(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    @staticmethod
    def dyadic(max_len: int, max_batch: int, min_len: int = 128,
               min_batch: int = 1) -> "BucketSpec":
        """Doubling rungs from ``min_len`` / ``min_batch`` up to the maxima
        (``base.yaml``: lengths 128–2048, batches 8–64)."""
        lens = [min_len]
        while lens[-1] < max_len:
            lens.append(min(lens[-1] * 2, max_len))
        bs = [min_batch]
        while bs[-1] < max_batch:
            bs.append(min(bs[-1] * 2, max_batch))
        return BucketSpec(tuple(lens), tuple(bs))


class EndlessSampler:
    """Infinite epoch-seeded shuffled index stream, keyed only by
    (seed, epoch)."""

    def __init__(self, n: int, seed: int = 0):
        self.n, self.seed = n, seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        return np.random.default_rng((self.seed, epoch)).permutation(self.n)

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            for i in self.epoch_indices(epoch):
                yield int(i)
            epoch += 1


def collate_1d(values: list[np.ndarray], pad: float = 0.0,
               max_len: int | None = None) -> np.ndarray:
    """Stack variable-length 1-D arrays into [B, L] (utils/__init__.py:44)."""
    L = max_len if max_len is not None else max(len(v) for v in values)
    out = np.full((len(values), L), pad, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        v = np.asarray(v)[:L]
        out[i, :len(v)] = v
    return out


def collate_2d(values: list[np.ndarray], pad: float = 0.0,
               max_len: int | None = None) -> np.ndarray:
    """Stack variable-length [T_i, D] arrays into [B, L, D]."""
    L = max_len if max_len is not None else max(v.shape[0] for v in values)
    D = np.asarray(values[0]).shape[1]
    out = np.full((len(values), L, D), pad, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        v = np.asarray(v)[:L]
        out[i, :v.shape[0]] = v
    return out
