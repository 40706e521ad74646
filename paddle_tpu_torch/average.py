"""Host-side weighted averaging (reference python/paddle/fluid/average.py:40
WeightedAverage -- deprecated there in favor of fluid.metrics, kept for
surface parity); the port's copy of ``paddle_tpu/average.py``."""
from __future__ import annotations

import warnings

import numpy as np


def _is_number_or_matrix(x):
    return isinstance(x, (int, float, np.ndarray)) or np.isscalar(x)


class WeightedAverage(object):
    """Accumulate sum(value * weight) / sum(weight) on the host."""

    def __init__(self):
        warnings.warn(
            "WeightedAverage is deprecated, use fluid.metrics instead "
            "(same note as the reference).", Warning)
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError("add(): value must be a number or ndarray")
        if not np.isscalar(weight):
            raise ValueError("add(): weight must be a number")
        # elementwise, like the reference: ndarray values average per element
        numerator = np.asarray(value, dtype=np.float64) * weight
        if self.numerator is None:
            self.numerator, self.denominator = numerator, float(weight)
        else:
            self.numerator = self.numerator + numerator
            self.denominator += float(weight)

    def eval(self):
        if self.numerator is None or self.denominator == 0.0:
            raise ValueError("eval() before any add() call")
        return self.numerator / self.denominator
