"""Per-rank bounded ring-buffer event recorder (counterpart of the JAX
package's ``trace/recorder.py``).

Each rank owns one bounded ring (a deque with maxlen: old events fall off,
memory is bounded by MV2T_TRACE_BUF) into which the instrumented lanes
append ``(timestamp, layer, name, phase, args)`` tuples:

    mpi       entry and exit of the Comm collectives (trace/__init__.py)
    channel   dev_coll_fallback instants (coll/device.py)
    device    dev_<coll> dispatch spans (coll/device.py), the ici_* and
              ici_axis_* tier instants (ops/ici.py, ops/alltoall.py),
              the rma_* spans and instants (rma/device.py), the
              nbc_dev_issue / nbc_dev_complete segment instants
              (coll/device.py _nb_poll)
    nbc       the NBC DAG's schedule and vertex events
              (coll/nbc/engine.py)

The JAX package's other lanes (protocol, progress, cplane) belong to
modules that are not ported. The dump (``dump_rank``) has the JAX
package's schema, so ``bin/mv2tconform`` and ``trace/perfetto.py`` of
that package read it unchanged.

Cost discipline: when tracing is off every instrumented site pays ONE
attribute check (``u.tracer is None``, or ``LOWERING.rec is None`` in
``ops/``): the recorder attaches to a rank's Universe only when the
MV2T_TRACE cvar is set, so the hot paths never consult the config.
Timestamps are CLOCK_MONOTONIC, system-wide on Linux, so the rank dumps
merge on one time axis.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.config import get_config

# the lanes the port records, a subset of the JAX package's LAYERS under
# the same names
LAYERS = ("mpi", "channel", "device", "nbc")


class Recorder:
    """One rank's bounded event ring. ``record`` is the only hot call."""

    __slots__ = ("rank", "events")

    def __init__(self, rank: int, capacity: int):
        self.rank = rank
        self.events: collections.deque = collections.deque(maxlen=capacity)

    def record(self, layer: str, name: str, ph: str = "i", **args) -> None:
        """Append one event. ``ph`` follows the Chrome trace-event phases:
        'B'egin / 'E'nd for spans, 'i' for instants. deque.append with a
        maxlen is atomic under the GIL, so no lock on the hot path."""
        self.events.append((time.monotonic(), layer, name, ph,
                            args or None))

    def tail(self, n: int) -> List[tuple]:
        """The most recent ``n`` events."""
        return list(self.events)[-n:]

    def snapshot(self) -> Dict[str, Any]:
        """The per-rank dump payload (the JAX package's schema)."""
        return {
            "rank": self.rank,
            "clock": "monotonic",
            "capacity": self.events.maxlen,
            "events": [[t, layer, name, ph, args]
                       for (t, layer, name, ph, args) in list(self.events)],
        }


class _Lowering(threading.local):
    """This thread's recorder while a device channel runs the first call
    of a program it has just built (``lowering``), else None. The JAX
    package's ``ici_*`` instants fire while a signature is traced, once a
    compiled signature, in the recorder of the tracing (leader) thread;
    the port fires its own at the same moment."""

    rec: Optional[Recorder] = None


LOWERING = _Lowering()


def lowering(rec: Recorder, fn: Callable) -> Callable:
    """``fn`` for one call with ``rec`` as this thread's
    ``LOWERING.rec``: the first call of a newly built program."""
    def first_call(*args):
        LOWERING.rec = rec
        try:
            return fn(*args)
        finally:
            LOWERING.rec = None
    return first_call


# ---------------------------------------------------------------------------
# attach / detach (the only code that consults the config registry)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_active: List[Recorder] = []


def maybe_attach(u) -> Optional[Recorder]:
    """Attach a recorder to Universe ``u`` iff the MV2T_TRACE cvar is set
    (``local_universe``, once a rank); also installs the ``mpi`` lane's
    wrappers while any recorder is live."""
    cfg = get_config()
    if not cfg["TRACE"]:
        u.tracer = None
        return None
    rec = Recorder(u.rank, max(256, int(cfg["TRACE_BUF"])))
    u.tracer = rec
    with _lock:
        _active.append(rec)
    from . import _install_mpi_tracer
    _install_mpi_tracer()
    return rec


def detach(u) -> None:
    """Drop ``u``'s recorder; the ``mpi`` wrappers come off when the last
    recorder leaves, so an untraced run after a traced one pays nothing."""
    rec = u.tracer
    if rec is None:
        return
    u.tracer = None
    with _lock:
        if rec in _active:
            _active.remove(rec)
        last = not _active
    if last:
        from . import _uninstall_mpi_tracer
        _uninstall_mpi_tracer()


def dump_rank(u) -> Optional[str]:
    """Write ``u``'s ring to MV2T_TRACE_DIR/trace-r<rank>.json (before the
    recorder detaches). Returns the path, or None without a recorder or a
    dump directory."""
    rec = u.tracer
    if rec is None:
        return None
    out_dir = get_config()["TRACE_DIR"]
    if not out_dir:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace-r{rec.rank}.json")
    with open(path, "w") as f:
        json.dump(rec.snapshot(), f)
    return path
