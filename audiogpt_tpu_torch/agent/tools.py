"""Tool registry with typed I/O, per-tool RTF counters and ``merge_audio``.

Counterpart of ``audiogpt_tpu/agent/tools.py:1-117``. Tools keep the
reference's surface contract (``audio-chatgpt.py:209``): string in, string
out, media as ``audio/<uuid8>.wav`` / ``image/<uuid8>.png`` paths; the
engines underneath are array-native. ``media_kind`` routes a result to a UI pane.
``merge_audio`` resamples with the port's ``dsp/resample.py`` (the JAX
version calls ``jax.numpy``, ``audiogpt_tpu/agent/tools.py:33-36``).
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
import wave
from typing import Callable, Iterable

import numpy as np
import torch

from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav
from audiogpt_tpu_torch.utils.profiling import RTFMeter


def new_media_path(kind: str = "audio", ext: str = "wav",
                   root: str = ".") -> str:
    os.makedirs(os.path.join(root, kind), exist_ok=True)
    return os.path.normpath(os.path.join(root, kind,
                                         f"{str(uuid.uuid4())[:8]}.{ext}"))


def merge_audio(path1: str, path2: str, root: str = ".",
                device: str | torch.device | None = None) -> str:
    """Concatenate two wavs at the second one's rate (the reference's
    ``merge_audio``, audio-chatgpt.py:92); the first is resampled to it on
    ``device`` (``None`` is the card; files at one rate need no device)."""
    w2, sr2 = load_wav(path2)
    w1, _ = load_wav(path1, sr=sr2, device=device)
    out = new_media_path("audio", root=root)
    save_wav(np.concatenate([w1, w2]), out, sr2)
    return out


def _wav_seconds(path: str) -> float:
    """Duration of a PCM wav from its header (no full read)."""
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / max(w.getframerate(), 1)
    except (OSError, EOFError, wave.Error):
        return 0.0


#: per-tool RTF/latency counters, exposed at the server's /stats endpoint
TOOL_STATS: dict = {}


def tool_stats_report() -> dict:
    return {name: {"calls": m.calls, "wall_s": round(m.wall, 4),
                   "audio_s": round(m.audio, 3),
                   "rtf": round(m.rtf, 5) if m.audio > 0 else None,
                   "mean_latency_s": round(m.wall / max(m.calls, 1), 4)}
            for name, m in TOOL_STATS.items()}


@dataclasses.dataclass
class Tool:
    name: str
    description: str
    fn: Callable[[str], str]
    media_kind: str = "audio"   # 'audio' | 'image' | 'video' | 'text'
    media_root: str = "."       # RTF probing resolves paths against this

    def __call__(self, text: str) -> str:
        meter = TOOL_STATS.setdefault(self.name, RTFMeter())
        t0 = time.perf_counter()
        out = self.fn(text)
        wall = time.perf_counter() - t0
        audio_s = 0.0
        if self.media_kind == "audio" and isinstance(out, str) \
                and out.endswith(".wav"):
            # tool outputs may be relative to the media root
            for cand in (out, os.path.join(self.media_root, out)):
                if os.path.isfile(cand):
                    audio_s = _wav_seconds(cand)
                    break
        meter.update(wall, audio_s)
        return out


class ToolRegistry:
    def __init__(self, tools: Iterable[Tool] = ()):  # insertion-ordered
        self._tools: dict[str, Tool] = {}
        for t in tools:
            self.add(t)

    def add(self, tool: Tool) -> None:
        self._tools[tool.name] = tool

    def get(self, name: str) -> Tool:
        if name not in self._tools:
            raise KeyError(f"unknown tool '{name}'; have {list(self._tools)}")
        return self._tools[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tools

    def names(self) -> list[str]:
        return list(self._tools)

    def descriptions(self) -> str:
        return "\n".join(f"> {t.name}: {t.description}"
                         for t in self._tools.values())
