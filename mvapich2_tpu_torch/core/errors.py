"""MPI error classes the port raises (a trimmed copy of the JAX
package's ``core/errors.py``; the numbering is the same)."""

from __future__ import annotations

MPI_SUCCESS = 0
MPI_ERR_COUNT = 2
MPI_ERR_TYPE = 3
MPI_ERR_REQUEST = 7
MPI_ERR_ROOT = 8
MPI_ERR_INTERN = 17
# ULFM extension class: a peer rank failed while this rank depended on it
MPIX_ERR_PROC_FAILED = 75


class MPIException(Exception):
    """Carries an MPI error class plus a human message."""

    def __init__(self, error_class: int, message: str):
        self.error_class = error_class
        super().__init__(message)
