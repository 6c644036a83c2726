"""MPI_Status and the reserved rank/tag constants (a copy of the JAX
package's ``core/status.py``)."""

from __future__ import annotations

from dataclasses import dataclass

from .errors import MPI_SUCCESS

ANY_SOURCE = -1
ANY_TAG = -2
PROC_NULL = -3
# an intercomm collective's root on the origin side (MPI_ROOT)
ROOT = -4
UNDEFINED = -32766


@dataclass
class Status:
    source: int = UNDEFINED
    tag: int = UNDEFINED
    error: int = MPI_SUCCESS
    count: int = 0          # bytes received
    cancelled: bool = False

    def get_count(self, datatype) -> int:
        """Number of complete datatype elements received (MPI_Get_count)."""
        ext = datatype.size
        if ext == 0:
            return 0
        if self.count % ext != 0:
            return UNDEFINED
        return self.count // ext

    def get_elements(self, datatype) -> int:
        basic = datatype.basic_size
        if basic == 0:
            return 0
        return self.count // basic
