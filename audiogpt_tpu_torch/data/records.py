"""Binary record store — the dataset serialization format of both packages.

Counterpart of ``audiogpt_tpu/data/records.py``, copied: the same bytes on
disk (``_MAGIC``, ``numpy.savez`` records, the JSON header and the int64
offset index), so a dataset written by either package trains the other.

Replaces the reference's ``IndexedDataset`` (``NeuralSeq/utils/indexed_datasets.py:7``):
a ``.data`` file of **pickled** dicts plus a pickled int64 offset index. Same
random-access contract, two deliberate changes:

  * records are serialized as ``numpy.savez`` archives (arrays + scalar/str
    object-free metadata) — no pickle on the read path, so a dataset file
    can't execute code;
  * the offset index is a flat little-endian int64 array behind a tiny JSON
    header, so it can be memory-mapped and shared across dataloader processes.

A record is a ``dict[str, np.ndarray | int | float | str]``.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Iterator, Mapping

import numpy as np

_MAGIC = b"AGTPUREC"
_META_PREFIX = "__meta__"


def _pack(record: Mapping[str, Any]) -> bytes:
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {}
    for k, v in record.items():
        if v is None:
            continue
        if isinstance(v, (int, float, str, bool)):
            meta[k] = v
        else:
            arr = np.asarray(v)
            if arr.dtype == object:
                raise TypeError(f"record field {k!r} has object dtype")
            arrays[k] = arr
    buf = io.BytesIO()
    arrays[_META_PREFIX] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack(raw: bytes) -> dict[str, Any]:
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        out: dict[str, Any] = {k: z[k] for k in z.files if k != _META_PREFIX}
        if _META_PREFIX in z.files:
            out.update(json.loads(z[_META_PREFIX].tobytes().decode()))
    return out


class RecordWriter:
    """Append-only writer; ``finalize()`` writes the index atomically
    (cf. the reference's ``IndexedDatasetBuilder.finalize``,
    ``indexed_datasets.py:57``)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        os.makedirs(os.path.dirname(os.path.abspath(prefix)) or ".", exist_ok=True)
        self._f = open(prefix + ".bin.part", "wb")
        self._offsets = [0]

    def add(self, record: Mapping[str, Any]) -> None:
        blob = _pack(record)
        self._f.write(blob)
        self._offsets.append(self._offsets[-1] + len(blob))

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def finalize(self) -> None:
        self._f.close()
        idx = np.asarray(self._offsets, dtype="<i8")
        header = json.dumps({"version": 1, "n": len(self)}).encode()
        with open(self.prefix + ".idx.part", "wb") as f:
            f.write(_MAGIC)
            f.write(np.asarray([len(header)], dtype="<i8").tobytes())
            f.write(header)
            f.write(idx.tobytes())
        # atomic publish (reference does .part + os.replace for checkpoints,
        # pl_utils.py:722-737; we apply the same discipline to data shards)
        os.replace(self.prefix + ".bin.part", self.prefix + ".bin")
        os.replace(self.prefix + ".idx.part", self.prefix + ".idx")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._f.closed:
            self.finalize()


class RecordDataset:
    """Random-access reader over a ``prefix.bin``/``prefix.idx`` pair."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + ".idx", "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{prefix}.idx: bad magic {magic!r}")
            (hlen,) = np.frombuffer(f.read(8), dtype="<i8")
            header = json.loads(f.read(int(hlen)).decode())
            self._offsets = np.frombuffer(f.read(), dtype="<i8")
        self._n = int(header["n"])
        if len(self._offsets) != self._n + 1:
            raise ValueError(f"{prefix}.idx: offset table truncated")
        self._data = open(prefix + ".bin", "rb")

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> dict[str, Any]:
        if not 0 <= i < self._n:
            raise IndexError(i)
        start, end = int(self._offsets[i]), int(self._offsets[i + 1])
        self._data.seek(start)
        return _unpack(self._data.read(end - start))

    def __iter__(self) -> Iterator[dict[str, Any]]:
        for i in range(self._n):
            yield self[i]

    def close(self) -> None:
        self._data.close()

    # pickling support for multiprocess loaders: reopen the fd lazily
    def __getstate__(self):
        return {"prefix": self.prefix}

    def __setstate__(self, state):
        self.__init__(state["prefix"])
