"""MPI error classes the port raises (a trimmed copy of the JAX
package's ``core/errors.py``; the numbering is the same), with the
dynamic-process classes of ``runtime/spawn.py`` and
``runtime/nameserv.py``, those of the topologies (``core/topo.py``),
the attribute caches (``core/attr.py``) and ``core/info.py``, and those
of the host windows (``rma/win.py``) and MPI-IO (``io/``). Error
handlers and the ULFM lease errors belong to tiers that are not
ported."""

from __future__ import annotations

MPI_SUCCESS = 0
MPI_ERR_BUFFER = 1
MPI_ERR_COUNT = 2
MPI_ERR_TYPE = 3
MPI_ERR_TAG = 4
MPI_ERR_COMM = 5
MPI_ERR_RANK = 6
MPI_ERR_REQUEST = 7
MPI_ERR_ROOT = 8
MPI_ERR_GROUP = 9
MPI_ERR_OP = 10
MPI_ERR_TOPOLOGY = 11
MPI_ERR_DIMS = 12
MPI_ERR_ARG = 13
MPI_ERR_UNKNOWN = 14
MPI_ERR_TRUNCATE = 15
MPI_ERR_OTHER = 16
MPI_ERR_INTERN = 17
MPI_ERR_KEYVAL = 20
MPI_ERR_PORT = 27
MPI_ERR_INFO = 28
MPI_ERR_FILE = 30
MPI_ERR_IO = 32
MPI_ERR_NAME = 33
MPI_ERR_NO_SUCH_FILE = 37
MPI_ERR_AMODE = 38
MPI_ERR_READ_ONLY = 40
MPI_ERR_SERVICE = 41
MPI_ERR_SPAWN = 42
MPI_ERR_UNSUPPORTED_DATAREP = 43
MPI_ERR_WIN = 45
MPI_ERR_RMA_SYNC = 50
# ULFM extension class: a peer rank failed while this rank depended on it
MPIX_ERR_PROC_FAILED = 75

_CLASS_NAMES = {v: k for k, v in list(globals().items())
                if k.startswith(("MPI_ERR", "MPI_SUCCESS", "MPIX_ERR"))}


class MPIException(Exception):
    """Carries an MPI error class plus a human message."""

    def __init__(self, error_class: int, message: str = ""):
        self.error_class = error_class
        super().__init__(message or _CLASS_NAMES.get(error_class,
                                                     "MPI error"))


def mpi_assert(cond: bool, klass: int, msg: str) -> None:
    if not cond:
        raise MPIException(klass, msg)
