"""Opening a binarized split.

Counterpart of ``load_split`` (``audiogpt_tpu/data/binarizer.py:282``). The
binarizers themselves (TTS, SVS, emotion, zh) come with the recipes that
train on their output; a split written by the JAX package's binarizers
reads here unchanged (``data/records.py``).
"""

from __future__ import annotations

import os

from audiogpt_tpu_torch.data.records import RecordDataset


def load_split(out_dir: str, split: str) -> RecordDataset:
    """The ``split`` records (``train``, ``valid``, ...) under ``out_dir``."""
    return RecordDataset(os.path.join(out_dir, split))
