"""Cross-request micro-batching for serving.

Counterpart of ``audiogpt_tpu/serving/batcher.py:29-210``.
Concurrent requests for one engine ride one batched call: requests enqueue
into a :class:`MicroBatcher`; a worker thread drains up to ``max_batch``
items, waiting at most ``window_ms`` for stragglers after the first
arrival; the engine's batch function runs once; each caller gets its own
result through a future. Any callable ``list[item] -> list[result]`` can be
wrapped: ``BatchedTTS`` and ``BatchedASR`` wrap the engines' batch calls.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Sequence

import numpy as np


class MicroBatcher:
    """Batch concurrent calls to ``batch_fn(items) -> results``.

    ``__call__`` blocks until the caller's result is ready; exceptions from
    ``batch_fn`` propagate to every caller in the affected batch.
    """

    #: batches kept in ``batch_log`` (the newest)
    LOG_CAP = 512

    def __init__(self, batch_fn: Callable[[Sequence[Any]], Sequence[Any]],
                 max_batch: int = 8, window_ms: float = 8.0,
                 name: str = "batcher"):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: list[tuple[Any, Future, float]] = []
        self._closed = False
        self.batches = 0          # stats: batch calls made
        self.items = 0            # stats: requests served
        #: the last ``LOG_CAP`` batches: queue wait of the oldest item,
        #: linger actually paid, batch_fn wall, batch size
        self.batch_log: collections.deque = collections.deque(
            maxlen=self.LOG_CAP)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=f"microbatch-{name}")
        self._worker.start()

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError(f"MicroBatcher {self.name!r} is closed")
            self._queue.append((item, fut, time.monotonic()))
            self._cond.notify()
        return fut

    def __call__(self, item: Any) -> Any:
        return self.submit(item).result()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                # first item arrived: linger briefly for stragglers
                t_linger = time.monotonic()
                deadline = t_linger + self.window_s
                while (len(self._queue) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            t_exec = time.monotonic()
            self.batches += 1
            self.items += len(items)
            try:
                results = self.batch_fn(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(items)} items")
            except Exception as e:  # propagate to every waiter
                results = None
                err = e
            t_done = time.monotonic()
            self.batch_log.append({
                "size": len(items),
                "queue_wait_s": t_exec - min(b[2] for b in batch),
                "linger_s": t_exec - t_linger,
                "exec_s": t_done - t_exec,
            })
            # set each future independently: a caller-cancelled future must
            # not poison its batchmates or kill the worker thread
            for idx, f in enumerate(futs):
                try:
                    if f.done():  # e.g. cancelled by the caller
                        continue
                    if results is not None:
                        f.set_result(results[idx])
                    else:
                        f.set_exception(err)
                except Exception:
                    pass


class BatchedTTS:
    """Micro-batching proxy for a TTS engine: concurrent ``__call__``s ride
    one FS2 pass (and one vocoder pass) through
    :meth:`TTSEngine.batch_synthesize`. A text beyond the largest token
    bucket runs the chunked long-form synthesis on the caller's thread, so
    it does not hold up the batch worker; a frontend error reaches the
    caller (the JAX proxy swallows it, ``batcher.py:160-167``). Every other
    attribute proxies to the engine."""

    def __init__(self, engine, max_batch: int = 8, window_ms: float = 8.0):
        self.engine = engine
        self.batcher = MicroBatcher(engine.batch_synthesize,
                                    max_batch=max_batch, window_ms=window_ms,
                                    name="tts")

    def warmup(self, token_buckets=None) -> None:
        """Run the engine over this batcher's batch ladder (1, 2, 4, …,
        max_batch) at every token bucket."""
        sizes, nb = [], 1
        while nb <= self.batcher.max_batch:
            sizes.append(nb)
            nb *= 2
        self.engine.warmup(batch_sizes=tuple(sizes),
                           token_buckets=token_buckets)

    def __call__(self, text: str):
        ids = self.engine.frontend.encode(text)
        if len(ids) > max(self.engine.bucketer.buckets):
            return self.engine(text)
        return self.batcher(text)

    def __getattr__(self, name):
        return getattr(self.engine, name)


class BatchedASR:
    """Micro-batching proxy for an ASR engine: concurrent default-task
    ``transcribe`` calls of at most 30 s ride one batched decode through
    :meth:`ASREngine.transcribe_batch`. Requests with another task, a fixed
    language, segments, another shape than [T] or longer audio (windowed)
    go to the engine on the caller's thread. Every other attribute proxies
    to the engine."""

    def __init__(self, engine, max_batch: int = 8, window_ms: float = 8.0):
        self.engine = engine
        self.batcher = MicroBatcher(engine.transcribe_batch,
                                    max_batch=max_batch, window_ms=window_ms,
                                    name="asr")

    def warmup(self) -> None:
        """Run the engine over this batcher's batch ladder (1, 2, 4, …,
        max_batch)."""
        sizes, nb = [], 1
        while nb <= self.batcher.max_batch:
            sizes.append(nb)
            nb *= 2
        self.engine.warmup(batch_sizes=tuple(sizes))

    def transcribe(self, wav, task: str = "translate",
                   language: int | None = None,
                   return_segments: bool = False):
        if task != "translate" or language is not None or return_segments \
                or np.ndim(wav) != 1 or len(wav) > self.engine.cfg.n_samples:
            return self.engine.transcribe(wav, task, language,
                                          return_segments=return_segments)
        return self.batcher(wav)

    def __getattr__(self, name):
        return getattr(self.engine, name)
