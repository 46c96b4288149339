"""The roofline's work count on cases counted by hand."""

import numpy as np

from mvebench.harness import fssr_work


def test_support_pairs_by_hand():
    # Two samples of scale 1 (support radius 3) and 0.5 (radius 1.5).
    pos = np.array([[0.0, 0, 0], [10.0, 0, 0]])
    scale = np.array([1.0, 0.5])
    corners = np.array([[0.0, 0, 0],      # in sample 0's support
                        [2.9, 0, 0],      # in sample 0's support
                        [3.0, 0, 0],      # on its rim: outside (the support is open)
                        [10.0, 1.4, 0],   # in sample 1's support
                        [10.0, 0, 1.5],   # on sample 1's rim: outside
                        [5.0, 0, 0]])     # in neither
    assert fssr_work.support_pairs(pos, scale, corners) == 3


def test_least_time_and_its_bound():
    # 1e9 pairs: 98e9 operations at 67 TFLOP/s against a few bytes.
    s, by = fssr_work.least_seconds(10**9, 10, 10, 67e12, 3.35e12)
    assert by == "operations" and np.isclose(s, 98e9 / 67e12)
    # No pairs: the bytes bound it, 44 per sample and 52 per corner.
    s, by = fssr_work.least_seconds(0, 1000, 2000, 67e12, 3.35e12)
    assert by == "bytes" and np.isclose(s, (44e3 + 104e3) / 3.35e12)
