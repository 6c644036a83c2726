"""Reduction operations the device channel maps (a trimmed copy of the
JAX package's ``core/op.py``): SUM, PROD, MAX and MIN.

``fn(a, b)`` reduces two numpy arrays, as in the JAX package; the device
channel does not call it, it maps the op to its own reduction by
identity.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class Op:
    def __init__(self, fn: Callable, name: str):
        self.fn = fn            # fn(invec, inoutvec) -> reduced ndarray
        self.name = name

    def __call__(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """reduce(a, b) - a is the incoming vector, b the accumulator."""
        return self.fn(a, b)

    def __repr__(self):
        return f"Op({self.name})"


SUM = Op(lambda a, b: a + b, "MPI_SUM")
PROD = Op(lambda a, b: a * b, "MPI_PROD")
MAX = Op(np.maximum, "MPI_MAX")
MIN = Op(np.minimum, "MPI_MIN")
