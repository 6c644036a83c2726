"""MPI error classes the port raises (a trimmed copy of the JAX
package's ``core/errors.py``; the numbering is the same), with the
dynamic-process classes of ``runtime/spawn.py`` and
``runtime/nameserv.py``. Error handlers and the ULFM lease errors belong
to tiers that are not ported."""

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
MPI_ERR_ARG = 13
MPI_ERR_UNKNOWN = 14
MPI_ERR_TRUNCATE = 15
MPI_ERR_OTHER = 16
MPI_ERR_INTERN = 17
MPI_ERR_PORT = 27
MPI_ERR_NAME = 33
MPI_ERR_SERVICE = 41
MPI_ERR_SPAWN = 42
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
