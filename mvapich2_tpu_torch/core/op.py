"""Reduction operations (a copy of the JAX package's ``core/op.py``).

``fn(a, b)`` reduces two numpy arrays: the host algorithms fold with
it. The device channels map SUM, PROD, MAX and MIN to their own
reductions by identity (``coll/device.py`` ``_op_name``); every other op,
and every user op, takes the host tier.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class Op:
    def __init__(self, fn: Callable, name: str, commutative: bool = True):
        self.fn = fn            # fn(invec, inoutvec) -> reduced ndarray
        self.name = name
        self.commutative = commutative
        self.is_user = False

    def __call__(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """reduce(a, b) - a is the incoming vector, b the accumulator."""
        return self.fn(a, b)

    def __repr__(self):
        return f"Op({self.name})"


def _logical(npfn):
    def fn(a, b):
        return npfn(a.astype(bool), b.astype(bool)).astype(b.dtype)
    return fn


def _minloc(a, b):
    out = b.copy()
    take = (a["val"] < b["val"]) | ((a["val"] == b["val"]) &
                                    (a["loc"] < b["loc"]))
    out[take] = a[take]
    return out


def _maxloc(a, b):
    out = b.copy()
    take = (a["val"] > b["val"]) | ((a["val"] == b["val"]) &
                                    (a["loc"] < b["loc"]))
    out[take] = a[take]
    return out


SUM = Op(lambda a, b: a + b, "MPI_SUM")
PROD = Op(lambda a, b: a * b, "MPI_PROD")
MAX = Op(np.maximum, "MPI_MAX")
MIN = Op(np.minimum, "MPI_MIN")
LAND = Op(_logical(np.logical_and), "MPI_LAND")
LOR = Op(_logical(np.logical_or), "MPI_LOR")
LXOR = Op(_logical(np.logical_xor), "MPI_LXOR")
BAND = Op(np.bitwise_and, "MPI_BAND")
BOR = Op(np.bitwise_or, "MPI_BOR")
BXOR = Op(np.bitwise_xor, "MPI_BXOR")
MINLOC = Op(_minloc, "MPI_MINLOC")
MAXLOC = Op(_maxloc, "MPI_MAXLOC")


def create_op(fn: Callable, commute: bool = True, name: str = "user_op") -> Op:
    """MPI_Op_create: fn(invec: ndarray, inoutvec: ndarray) -> ndarray."""
    op = Op(fn, name, commute)
    op.is_user = True
    return op
