"""Request objects (a copy of the JAX package's ``core/request.py``).

A Request is a completion promise tied to its rank's progress engine
(``transport/progress.py``). ``test`` runs one progress pass; blocking
waits funnel into the engine's ``progress_wait``, which polls and sleeps
on the engine's doorbell, rung by any thread that delivers a packet or
completes a request. Completion callbacks chain the protocol state
machines (rendezvous CTS -> data -> FIN), the nonblocking-collective
schedules (``coll/nbc``) and the persistent requests. The JAX package's
generalized requests (``Grequest``) wait with the C ABI that uses them.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .errors import MPIException, MPI_ERR_REQUEST
from .status import Status

REQUEST_NULL = None


class Request:
    _ids = iter(range(1, 1 << 62))

    def __init__(self, engine=None, kind: str = "generic"):
        self.engine = engine          # progress engine that completes me
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

    # -- completion (called with engine lock held or from engine.complete) --
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
        """Thread-safe completion via the owning engine."""
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
            self.engine.progress_poke()
        return self.complete_flag

    def wait(self) -> Status:
        # already-complete fast path (every eager send): complete_flag
        # only ever transitions False->True, so an unlocked read that
        # sees True is safe and skips the progress mutex+poll
        if not self.complete_flag:
            if self.engine is not None:
                self.engine.progress_wait(lambda: self.complete_flag)
            else:
                raise MPIException(MPI_ERR_REQUEST,
                                   "wait on engine-less incomplete request")
        if self.error is not None:
            raise self.error
        return self.status

    def cancel(self) -> None:
        # Recv cancel = matching-queue removal; send cancel resolves
        # asynchronously through the protocol (see pt2pt/protocol.py).
        # _cancel_override marks requests (persistent sends) whose
        # local completion does not preclude cancelling.
        if self.complete_flag and not getattr(self, "_cancel_override",
                                              False):
            return
        canceller = self._cancel_fn
        if canceller is not None and canceller():
            self.cancelled = True
            self.status.cancelled = True
            self.complete()

    def free(self) -> None:
        pass

    # -- persistent requests (MPI_Send_init / MPI_Start) ------------------
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


class CompletedRequest(Request):
    """Immediately-complete request (e.g. self-send fast path, 0-byte ops)."""

    def __init__(self, status: Optional[Status] = None):
        super().__init__(None, "completed")
        if status is not None:
            self.status = status
        self.complete_flag = True


def waitall(requests: List[Optional[Request]]) -> List[Status]:
    stats = []
    for r in requests:
        stats.append(r.wait() if r is not None else Status())
    return stats


def waitany(requests: List[Optional[Request]]) -> int:
    """Returns index of a completed request; progresses until one completes."""
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
    """(index, flag): first completed request's index, or (-1, False)."""
    for i, r in enumerate(requests):
        if r is not None and r.test():
            if r.error is not None:
                raise r.error
            return i, True
    return -1, False


def waitsome(requests: List[Optional[Request]]) -> List[int]:
    """Indices of all completed requests after at least one completes."""
    first = waitany(requests)
    if first < 0:
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
