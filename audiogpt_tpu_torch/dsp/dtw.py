"""Dynamic time warping over feature sequences: a host-side metric.

Counterpart of ``audiogpt_tpu/dsp/dtw.py``, numpy, as in JAX. Reference:
``NeuralSeq/utils/dtw.py`` (the numpy DTW of GenerSpeech's evaluation,
which aligns reference and output mels before a distance). The cost matrix
and the optimal path come from the cumulative DP, one row at a time; the
left neighbour's dependency keeps the inner loop a scan.
"""

from __future__ import annotations

import numpy as np


def dtw(x: np.ndarray, y: np.ndarray, dist=None
        ) -> tuple[float, np.ndarray, np.ndarray]:
    """Align ``x`` [Tx, D] to ``y`` [Ty, D].

    Returns (total_cost, accumulated_cost_matrix, path [L, 2]).
    """
    x = np.atleast_2d(np.asarray(x, np.float64))
    y = np.atleast_2d(np.asarray(y, np.float64))
    if dist is None:
        # pairwise euclidean
        d = np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    else:
        d = np.asarray([[dist(a, b) for b in y] for a in x])
    tx, ty = d.shape
    acc = np.full((tx + 1, ty + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, tx + 1):
        acc[i, 1:] = d[i - 1]
        m = np.minimum(acc[i - 1, :-1], acc[i - 1, 1:])
        # left-neighbor dependency forces the inner scan
        prev = np.inf
        for j in range(1, ty + 1):
            best = min(m[j - 1], prev)
            acc[i, j] = d[i - 1, j - 1] + best
            prev = acc[i, j]
    # backtrack
    path = [(tx - 1, ty - 1)]
    i, j = tx, ty
    while i > 1 or j > 1:
        steps = [(i - 1, j - 1), (i - 1, j), (i, j - 1)]
        costs = [acc[a, b] for a, b in steps]
        i, j = steps[int(np.argmin(costs))]
        path.append((i - 1, j - 1))
    return float(acc[tx, ty]), acc[1:, 1:], np.asarray(path[::-1])


def mel_cepstral_distortion(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """DTW-aligned MCD-style distance between two (log-)mel sequences —
    the GenerSpeech eval metric shape."""
    _, _, path = dtw(mel_a, mel_b)
    a = mel_a[path[:, 0]]
    b = mel_b[path[:, 1]]
    return float(np.sqrt(((a - b) ** 2).sum(-1)).mean())
