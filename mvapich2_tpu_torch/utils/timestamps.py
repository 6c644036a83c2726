"""Startup phase profiling (the JAX package's ``utils/timestamps.py``,
the mv2_take_timestamp analog, trimmed to what ``mpi.Init`` uses):
``phase(label)`` brackets an init phase (nesting allowed), and
``print_timestamps()`` prints the tree with durations to stderr. Both do
nothing unless ``MV2T_STARTUP_TIMING`` is set.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import List

from .config import get_config

_t0 = time.perf_counter()
_lock = threading.Lock()
_records: List[list] = []        # [label, depth, t_enter, t_exit]
_depth = [0]


@contextlib.contextmanager
def phase(label: str):
    if not get_config()["STARTUP_TIMING"]:
        yield
        return
    with _lock:
        rec = [label, _depth[0], time.perf_counter(), None]
        _records.append(rec)
        _depth[0] += 1
    try:
        yield
    finally:
        with _lock:
            rec[3] = time.perf_counter()
            _depth[0] -= 1


def print_timestamps() -> None:
    if not get_config()["STARTUP_TIMING"]:
        return
    lines = ["startup timestamps (s since t0):"]
    with _lock:
        for label, depth, t_in, t_out in _records:
            dur = "%.6f" % (t_out - t_in) if t_out is not None else "open"
            lines.append(f"  {'  ' * depth}{label:<40} @{t_in - _t0:.6f}  "
                         f"dur={dur}")
    print("\n".join(lines), file=sys.stderr)
