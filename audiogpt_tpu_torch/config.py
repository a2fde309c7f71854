"""Immutable config system with recursive YAML inheritance.

Counterpart of ``audiogpt_tpu/config.py``, copied: the port imports nothing
of the JAX package, this pure-Python module included. PyYAML is imported
inside the functions that read or write YAML. It reads the repository's
``configs/``.

Replaces the reference's process-global mutable ``hparams`` dict
(``NeuralSeq/utils/hparams.py:23-129``) — whose global mutation makes tools
non-reentrant (``audio-chatgpt.py:286-291``) — with an immutable, hashable
``Config`` passed explicitly to every engine and trainer.

Feature parity with the reference's config loader:
  * recursive multi-parent inheritance via a ``base_config`` key
    (hparams.py:49-70),
  * CLI-style dot-path overrides ``"a.b=1,c=[1, 2]"`` (hparams.py:91-104),
  * persistence of the resolved config next to checkpoints (hparams.py:109-112).
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Iterator, Mapping


class Config(Mapping[str, Any]):
    """A frozen, nested, dict-like configuration.

    Nested dicts are wrapped lazily, attribute access mirrors item access, and
    the object is hashable (by its canonical JSON), so a Config can key a
    cache safely.
    """

    __slots__ = ("_data", "_hash")

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        merged = dict(data or {})
        merged.update(kw)
        object.__setattr__(self, "_data", _freeze(merged))
        object.__setattr__(self, "_hash", None)

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # -- Attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        raise TypeError("Config is immutable; use .replace(**kw)")

    # -- Utilities ------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def replace(self, **kw: Any) -> "Config":
        """Return a new Config with top-level keys replaced."""
        data = dict(self._data)
        data.update(kw)
        return Config(data)

    def updated(self, other: Mapping[str, Any]) -> "Config":
        """Deep-merge ``other`` into this config (other wins)."""
        return Config(_deep_merge(self.to_dict(), dict(other)))

    def override(self, spec: str) -> "Config":
        """Apply CLI-style overrides: ``"a.b=1,c=[1, 2],name=foo"``."""
        data = self.to_dict()
        for clause in _split_clauses(spec):
            if not clause.strip():
                continue
            path, _, raw = clause.partition("=")
            node = data
            keys = path.strip().split(".")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = _parse_value(raw.strip())
        return Config(data)

    def to_dict(self) -> dict:
        return _thaw(self._data)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def save(self, path: str) -> None:
        import yaml

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=True)

    def __hash__(self) -> int:
        h = object.__getattribute__(self, "_hash")
        if h is None:
            h = hash(self.to_json())
            object.__setattr__(self, "_hash", h)
        return h

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self._data == other._data
        if isinstance(other, Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def _freeze(x: Any) -> Any:
    if isinstance(x, Config):
        return x._data
    if isinstance(x, Mapping):
        return {k: _freeze(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


def _thaw(x: Any) -> Any:
    if isinstance(x, Mapping):
        return {k: _thaw(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return [_thaw(v) for v in x]
    return x


def _deep_merge(base: dict, new: Mapping[str, Any]) -> dict:
    out = dict(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(dict(out[k]), v)
        else:
            out[k] = _thaw(_freeze(v))
    return out


def _split_clauses(spec: str) -> list[str]:
    """Split on commas not inside brackets/quotes."""
    out, depth, cur, quote = [], 0, [], None
    for ch in spec:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _parse_value(raw: str) -> Any:
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    if raw.lower() in ("none", "null"):
        return None
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def load_config(
    path: str,
    overrides: str = "",
    extra: Mapping[str, Any] | None = None,
) -> Config:
    """Load a YAML config, resolving recursive ``base_config`` inheritance.

    ``base_config`` may be a string or list of strings, each a path either
    relative to the current file's directory or to the repo root. Parents are
    merged in order, children win (mirrors hparams.py:49-70 semantics).
    """
    data = _load_recursive(os.path.abspath(path), seen=set())
    data.pop("base_config", None)
    cfg = Config(data)
    if extra:
        cfg = cfg.updated(extra)
    if overrides:
        cfg = cfg.override(overrides)
    return cfg


def _load_recursive(path: str, seen: set) -> dict:
    import yaml

    if path in seen:
        raise ValueError(f"config inheritance cycle at {path}")
    seen = seen | {path}
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    bases = raw.get("base_config", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        cand = b if os.path.isabs(b) else os.path.join(os.path.dirname(path), b)
        if not os.path.exists(cand):
            cand = os.path.join(_repo_root(), b)
        parent = _load_recursive(os.path.abspath(cand), seen)
        parent.pop("base_config", None)
        merged = _deep_merge(merged, parent)
    return _deep_merge(merged, raw)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
