"""The work FSSR's evaluation needs, counted from its input, whatever
implements it: the (corner, sample) pairs whose corner lies inside the
sample's support (|x - p| < 3 s), the operations each pair needs, and
the bytes the evaluation has to move.

Operations per pair, from the formulas of reference/fssrecon.py (a
multiply-add counts two, exp and sqrt one each):
  offset d = x - p                         3
  |d|^2, q = |d|^2 / s^2, rim test         5 + 1 + 1
  scale filter (compare against the
    corner's threshold)                    1
  x_n = d . n                              5
  g = exp(-|d|^2 / 2 s^2)                  2
  f = x_n g / (2 pi s^4)                   2
  w(q) (Horner, with sqrt q)               6
  f w c, w c and their two sums            4
  grad f (3 components)                    2 + 1 + 3 * 6
  grad w (3 components) and w'(q)          4 + 2 + 3
  (grad f w + grad w f) c, summed (3)      3 * 5
  g_c = exp(-|d|^2 / 2 sc^2) / (sc sqrt(2pi)) c,
    its sum and the scale sum              4 + 1 + 2
  colour sums (3)                          3 * 2
  ------------------------------------------------
                                          98
Bytes: each sample's position, normal, scale, confidence and colour
(11 float32) read once, each corner's position (3 float32) read once
and its ten float32 sums written once.
"""

from __future__ import annotations

import numpy as np

FLOPS_PER_PAIR = 98
SAMPLE_BYTES = 11 * 4
CORNER_BYTES = 3 * 4 + 10 * 4


def support_pairs(sample_pos: np.ndarray, sample_scale: np.ndarray, corners: np.ndarray) -> int:
    """How many (corner, sample) pairs have the corner inside the sample's
    support: strictly closer than three times the sample's scale."""
    from scipy.spatial import cKDTree

    tree = cKDTree(corners)
    # query_ball_point counts distances <= r; the support is open, so the
    # radius is taken one float64 step below 3 s.
    r = np.nextafter(3.0 * sample_scale, 0.0)
    return int(tree.query_ball_point(sample_pos, r, return_length=True, workers=-1).sum())


def least_seconds(pairs: int, n_samples: int, n_corners: int, flops: float, bytes_per_s: float):
    """(seconds, which bound) the device needs at best for this work."""
    ops = pairs * FLOPS_PER_PAIR / flops
    mem = (n_samples * SAMPLE_BYTES + n_corners * CORNER_BYTES) / bytes_per_s
    return (ops, "operations") if ops >= mem else (mem, "bytes")
