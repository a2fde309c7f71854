"""Host input pipeline of the fixed-shape recipes: records → static-shape
numpy batches.

Counterpart of ``audiogpt_tpu/data/loader.py`` for the recipes that train on
one static shape (``ArrayDataLoader``, ``collate_mel_image``; the LDM
recipe). Every batch has the same shape, so the step's kernels, their
launch configurations and the allocator's blocks repeat from step to step;
the final short batch of an epoch pads with dummy rows of weight 0, so the
loss is unchanged. Batches stay numpy: the trainer copies each to the device
once. The token-budget loaders of the TTS recipes come with those recipes.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np


def _pad_tokens(tok, n: int) -> np.ndarray:
    t = np.asarray(tok, np.int32)[:n]
    return np.pad(t, (0, n - len(t)))


def collate_mel_image(samples: list[dict], width: int,
                      text_len: int | None = None) -> dict[str, np.ndarray]:
    """LDM/VAE batch: records with ``mel`` [T, M] in LDM domain [0, 1]
    (``TRANSFORMS_16000`` output, extract_mel_spectrogram.py:140) → VAE-domain
    images [B, M, width, 1] in [-1, 1] (NHWC, as the JAX batch; the task
    transposes); optional CLAP ``text_ids`` [B, text_len] and
    ``text_mask``."""
    mels = []
    for s in samples:
        # records store [T, M] (binarizer convention) → image rows = mels
        m = np.asarray(s["mel"], np.float32).T
        m = m[:, :width]
        m = np.pad(m, ((0, 0), (0, width - m.shape[1])))
        mels.append(m * 2.0 - 1.0)
    batch = {"mels": np.stack(mels)[..., None],
             "weight": np.ones(len(samples), np.float32)}
    if text_len is not None and "text_ids" in samples[0]:
        batch["text_ids"] = np.stack(
            [_pad_tokens(s["text_ids"], text_len) for s in samples])
        batch["text_mask"] = (batch["text_ids"] != 0).astype(np.int32)
    return batch


class ArrayDataLoader:
    """Fixed-batch, fixed-shape loader for the non-bucketed recipes.

    One static shape per instance. The final short batch of an epoch pads
    with dummy rows (weight 0) so the shape never changes. Iterating
    (training) reshuffles per epoch forever; ``epoch(e)`` yields a single
    deterministic pass (validation). The permutation is keyed by (seed,
    epoch) with numpy's generator, as JAX's loader keys it."""

    def __init__(self, ds, collate: Callable[[list[dict]], dict],
                 batch_size: int, shuffle: bool = True, seed: int = 1234,
                 shard: int = 0, num_shards: int = 1):
        self.ds = ds
        self.collate = collate
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard, self.num_shards = shard, num_shards

    def _pad_batch(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        n = len(batch["weight"])
        if n == self.batch_size:
            return batch
        pad = self.batch_size - n
        out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
               for k, v in batch.items()}
        out["weight"][n:] = 0.0
        return out

    def epoch(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        idx = idx[self.shard::self.num_shards]
        for i in range(0, len(idx), self.batch_size):
            chunk = [self.ds[int(j)] for j in idx[i: i + self.batch_size]]
            yield self._pad_batch(self.collate(chunk))

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
