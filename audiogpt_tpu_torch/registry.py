"""Named registries for models, vocoders, engines, tools, tasks and text
processors.

Counterpart of ``audiogpt_tpu/registry.py``: the same ``Registry`` class
and the same six registries, filled by decorators at the same places as
JAX's (the engines under their tool names, the vocoders — JAX's ``pwg``
names the ``ConvInUpsample`` under its decorator, and so does this — and
the English frontend as ``en``). It generalises the reference's vocoder
registry (``NeuralSeq/vocoders/base_vocoder.py:5-19``). The app's engine
factories (``app.py`` ``_FACTORIES``) and the wav processors
(``data/wav_processors.py`` ``WAV_PROCESSORS``) stay plain dicts, as in
JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str | None = None) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            key = name or getattr(obj, "__name__", str(obj))
            key = key.lower()
            if key in self._items and self._items[key] is not obj:
                raise KeyError(f"{self.kind} '{key}' already registered")
            self._items[key] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        key = name.lower()
        if key not in self._items:
            raise KeyError(
                f"unknown {self.kind} '{name}'; have {sorted(self._items)}"
            )
        return self._items[key]

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def names(self) -> list[str]:
        return sorted(self._items)


MODELS: Registry = Registry("model")
VOCODERS: Registry = Registry("vocoder")
ENGINES: Registry = Registry("engine")
TOOLS: Registry = Registry("tool")
TASKS: Registry = Registry("task")
TEXT_PROCESSORS: Registry = Registry("text_processor")
