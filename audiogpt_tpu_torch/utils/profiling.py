"""Real-time-factor counter of the agent's tools.

Counterpart of ``audiogpt_tpu/utils/profiling.py:51-80`` (``RTFMeter``, less
its ``measure`` context manager, which nothing calls); the JAX file's XLA
timers and trace helpers have no counterpart here (``chip_smoke.py`` times
the card with CUDA events and ``torch.profiler``).
"""

from __future__ import annotations

import threading


class RTFMeter:
    """Real-time-factor counter: feed (wall_seconds, audio_seconds) pairs.

    Thread-safe: the server updates meters from concurrent HTTP handler
    threads."""

    def __init__(self):
        self.wall = 0.0
        self.audio = 0.0
        self.calls = 0
        self._lock = threading.Lock()

    def update(self, wall_s: float, audio_s: float) -> None:
        with self._lock:
            self.wall += wall_s
            self.audio += audio_s
            self.calls += 1

    @property
    def rtf(self) -> float:
        return self.wall / max(self.audio, 1e-9)
