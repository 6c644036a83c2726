"""Distributed event tracing of the port (counterpart of the JAX
package's ``trace/__init__.py``): the ring-buffer recorder and the ``mpi``
lane.

Workflow: set MV2T_TRACE=1 and MV2T_TRACE_DIR=<dir>; ``run_ranks`` writes
each rank's ring to ``<dir>/trace-r<rank>.json`` when its ranks end, in
the JAX package's dump format, which its ``bin/mv2tconform`` checks and
its ``trace/perfetto.py`` merges into one Chrome trace-event JSON.

The ``mpi`` lane: a B/E span around each Comm collective of the JAX
package's ``profile.py`` ``PROFILED_METHODS`` that the port has (the
blocking ones and their ``i*`` twins), in the recorder of the comm's
universe, installed while any recorder is live.
"""

from __future__ import annotations

import threading

from .recorder import (LAYERS, LOWERING, Recorder, detach,  # noqa: F401
                       dump_rank, lowering, maybe_attach)

MPI_METHODS = ("bcast", "reduce", "allreduce", "allgather", "alltoall",
               "reduce_scatter_block", "ibarrier", "ibcast", "iallreduce",
               "iallgather", "ialltoall", "ireduce", "ialltoallv",
               "ireduce_scatter_block")

_mpi_lock = threading.Lock()
_originals = {}


def _traced(name: str, real):
    def method(self, *args, **kwargs):
        u = self.u
        rec = u.tracer if u is not None else None
        if rec is None:     # a comm of an untraced universe
            return real(self, *args, **kwargs)
        rec.record("mpi", name, "B")
        try:
            return real(self, *args, **kwargs)
        finally:
            rec.record("mpi", name, "E")
    method.__name__ = name
    method.__wrapped__ = real
    return method


def _install_mpi_tracer() -> None:
    from ..core.comm import Comm
    with _mpi_lock:
        if _originals:
            return
        for name in MPI_METHODS:
            real = Comm.__dict__[name]
            _originals[name] = real
            setattr(Comm, name, _traced(name, real))


def _uninstall_mpi_tracer() -> None:
    from ..core.comm import Comm
    with _mpi_lock:
        for name, real in _originals.items():
            setattr(Comm, name, real)
        _originals.clear()
