"""Serving: cross-request micro-batching (``batcher``)."""

from audiogpt_tpu_torch.serving.batcher import (BatchedASR,  # noqa: F401
                                                BatchedTTS, MicroBatcher)
