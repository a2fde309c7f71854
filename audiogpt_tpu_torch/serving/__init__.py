"""Serving: the HTTP API and chat UI (``server``) and cross-request
micro-batching (``batcher``)."""

from audiogpt_tpu_torch.serving.batcher import (BatchedASR,  # noqa: F401
                                                BatchedTTS, MicroBatcher)
from audiogpt_tpu_torch.serving.server import AppServer, make_server  # noqa: F401
