"""Request objects (a trimmed copy of the JAX package's ``core/request.py``).

A Request is a completion promise tied to its rank's NBC engine
(``coll/nbc/engine.py``): ``test`` runs one progress pass of the engine,
``wait`` runs passes until the request completes, sleeping between them
on the engine's doorbell. Completion callbacks chain a persistent
request to the nonblocking request each ``start`` posts. The JAX
package's generalized requests (``Grequest``) belong to its host tier and
are not ported.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .errors import MPI_ERR_REQUEST, MPI_SUCCESS, MPIException


class Status:
    """What a completed request reports: its error class (MPI_SUCCESS
    when none) and whether it was cancelled."""

    __slots__ = ("error", "cancelled")

    def __init__(self):
        self.error = MPI_SUCCESS
        self.cancelled = False


class Request:
    _ids = iter(range(1, 1 << 62))

    def __init__(self, engine=None, kind: str = "generic"):
        self.engine = engine          # the NBC engine that completes me
        self.kind = kind
        self.status = Status()
        self.complete_flag = False
        self.error: Optional[MPIException] = None
        self.cancelled = False
        self._callbacks: List[Callable] = []
        self.persistent = False
        self._start_fn: Optional[Callable] = None  # for persistent requests
        self._cancel_fn: Optional[Callable[[], bool]] = None
        self.device_nbc = False       # rides the device NBC tier
        self.req_id = next(Request._ids)

    # -- completion (under the engine's mutex when there is an engine) ---
    def add_callback(self, cb: Callable) -> None:
        if self.complete_flag:
            cb(self)
        else:
            self._callbacks.append(cb)

    def _fire(self) -> None:
        self.complete_flag = True
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def complete(self, error: Optional[MPIException] = None) -> None:
        """Complete through the owning engine (or at once without one)."""
        if error is not None:
            self.error = error
            self.status.error = error.error_class
        if self.engine is not None:
            self.engine.complete_request(self)
        else:
            self._fire()

    # -- user-facing ------------------------------------------------------
    def test(self) -> bool:
        if not self.complete_flag and self.engine is not None:
            self.engine.progress()
        return self.complete_flag

    def wait(self) -> Status:
        if not self.complete_flag:
            if self.engine is None:
                raise MPIException(MPI_ERR_REQUEST,
                                   "wait on engine-less incomplete request")
            self.engine.progress_wait(lambda: self.complete_flag)
        if self.error is not None:
            raise self.error
        return self.status

    def cancel(self) -> None:
        if self.complete_flag:
            return
        if self._cancel_fn is not None and self._cancel_fn():
            self.cancelled = True
            self.status.cancelled = True
            self.complete()

    def free(self) -> None:
        pass

    # -- persistent requests (MPI_*_init / MPI_Start) ---------------------
    def start(self) -> None:
        if not self.persistent or self._start_fn is None:
            raise MPIException(MPI_ERR_REQUEST, "not a persistent request")
        self.complete_flag = False
        self.error = None
        self.status = Status()
        self._start_fn(self)

    def __repr__(self):
        return (f"Request({self.kind}, id={self.req_id}, "
                f"{'done' if self.complete_flag else 'pending'})")


def waitall(requests: List[Optional[Request]]) -> List[Status]:
    return [r.wait() if r is not None else Status() for r in requests]


def waitany(requests: List[Optional[Request]]) -> int:
    """The index of a completed request; progresses until one completes
    (-1 when every entry is None)."""
    live = [(i, r) for i, r in enumerate(requests) if r is not None]
    if not live:
        return -1
    engine = next((r.engine for _, r in live if r.engine is not None), None)

    def any_done():
        return any(r.complete_flag for _, r in live)

    if engine is not None:
        engine.progress_wait(any_done)
    for i, r in live:
        if r.complete_flag:
            if r.error is not None:
                raise r.error
            return i
    raise MPIException(MPI_ERR_REQUEST, "waitany: nothing completed")


def testall(requests: List[Optional[Request]]) -> bool:
    return all(r is None or r.test() for r in requests)


def testany(requests: List[Optional[Request]]):
    """(index, flag): the first completed request's index, or (-1, False)."""
    for i, r in enumerate(requests):
        if r is not None and r.test():
            if r.error is not None:
                raise r.error
            return i, True
    return -1, False


def waitsome(requests: List[Optional[Request]]) -> List[int]:
    """The indices of every completed request, once at least one has."""
    if waitany(requests) < 0:
        return []
    out = []
    for i, r in enumerate(requests):
        if r is not None and r.complete_flag:
            if r.error is not None:
                raise r.error
            out.append(i)
    return out


def testsome(requests: List[Optional[Request]]) -> List[int]:
    out = []
    for i, r in enumerate(requests):
        if r is not None and r.test():
            if r.error is not None:
                raise r.error
            out.append(i)
    return out
