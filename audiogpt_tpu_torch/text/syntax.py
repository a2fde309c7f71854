"""Word-level syntactic graphs for SyntaSpeech, as dense per-edge-type
adjacency tensors ``[N_EDGE_TYPES, W, W]``.

Copy of ``audiogpt_tpu/text/syntax.py:1-133`` (host numpy; the port imports
nothing of the JAX package). The reference builds a dgl graph from a stanza
dependency parse (``NeuralSeq/modules/syntaspeech/syntactic_graph_buider.py``);
without a parser, each punctuation-delimited clause is a star around its
middle word, and ``dep_heads`` (1-based head per word, 0 = clause root)
takes a real parse in the same layout. The GGNN of
``models/tts/portaspeech.py`` passes messages as ``adj @ h``.

Edge types (6, the reference's ``n_etypes``):
  0: sequential forward  (w_i -> w_{i+1})
  1: sequential backward (w_{i+1} -> w_i)
  2: self loop           (w_i -> w_i)
  3: dependent -> head
  4: head -> dependent
  5: inter-clause head links (both directions)
"""

from __future__ import annotations

import numpy as np

N_EDGE_TYPES = 6

_CLAUSE_PUNCT = {",", ".", ";", ":", "!", "?", "，", "。", "；", "：", "！", "？", "|"}


def _heuristic_heads(words: list[str]) -> list[int]:
    """Parser-free head assignment: split on punctuation into clauses; every
    word in a clause points at the clause's middle word (a star), which
    stands in for the dependency root. Punctuation tokens point at the
    preceding clause head."""
    heads = [0] * len(words)
    clause: list[int] = []

    def close(clause: list[int]):
        if not clause:
            return -1
        root = clause[len(clause) // 2]
        for i in clause:
            heads[i] = 0 if i == root else root + 1  # 1-based head, 0 = root
        return root

    last_root = -1
    orphan_punct: list[int] = []   # punctuation before any clause root
    for i, w in enumerate(words):
        if w in _CLAUSE_PUNCT:
            r = close(clause)
            last_root = r if r >= 0 else last_root
            if last_root >= 0:
                heads[i] = last_root + 1
            else:
                orphan_punct.append(i)
            clause = []
        else:
            clause.append(i)
    r = close(clause)
    last_root = r if r >= 0 else last_root
    # leading punctuation attaches to the FOLLOWING clause's root: head 0
    # would make it a clause root itself and wire it into the type-5
    # inter-clause graph
    if orphan_punct:
        following = [i for i, h in enumerate(heads)
                     if h == 0 and i not in set(orphan_punct)
                     and words[i] not in _CLAUSE_PUNCT]
        for i in orphan_punct:
            nxt = next((r for r in following if r > i), None)
            if nxt is None and following:
                nxt = following[-1]
            heads[i] = (nxt + 1) if nxt is not None else 0
    return heads


def build_word_graph(
    words: list[str],
    max_words: int | None = None,
    dep_heads: list[int] | None = None,
) -> np.ndarray:
    """words -> dense adjacency ``[N_EDGE_TYPES, W, W]`` (float32).

    ``adj[e, i, j] = 1`` encodes an edge ``j -> i`` of type ``e`` (so message
    passing is ``adj @ h``). ``dep_heads[i]`` is the 1-based index of word
    i's syntactic head (0 = clause root), e.g. from an external parser;
    defaults to the punctuation-clause heuristic above.
    """
    n = len(words)
    w = max_words if max_words is not None else n
    if n > w:
        raise ValueError(f"{n} words exceed max_words={w}")
    adj = np.zeros((N_EDGE_TYPES, w, w), np.float32)
    if n == 0:
        return adj
    heads = dep_heads if dep_heads is not None else _heuristic_heads(words)

    idx = np.arange(n - 1)
    adj[0, idx + 1, idx] = 1.0          # sequential forward
    adj[1, idx, idx + 1] = 1.0          # sequential backward
    adj[2, np.arange(n), np.arange(n)] = 1.0  # self loops

    roots: list[int] = []
    for i, h in enumerate(heads[:n]):
        if h <= 0:
            roots.append(i)
        else:
            adj[3, h - 1, i] = 1.0      # dependent -> head
            adj[4, i, h - 1] = 1.0      # head -> dependent
    for a in roots:                     # inter-clause full graph over roots
        for b in roots:
            if a != b:
                adj[5, a, b] = 1.0
    return adj


def batch_word_graphs(word_lists: list[list[str]], max_words: int,
                      dep_heads: list[list[int] | None] | None = None
                      ) -> np.ndarray:
    """Stack per-sample graphs into ``[B, E, max_words, max_words]``."""
    out = np.zeros((len(word_lists), N_EDGE_TYPES, max_words, max_words),
                   np.float32)
    for b, words in enumerate(word_lists):
        dh = dep_heads[b] if dep_heads is not None else None
        out[b] = build_word_graph(words, max_words, dh)
    return out
