"""The scheduler of the nonblocking device collectives' DAGs (a trimmed
copy of the JAX package's ``coll/nbc/engine.py``).

One ``NbcEngine`` rides each rank's ``Universe`` (``u.engine``) and holds
that rank's schedules in flight. It has no progress thread: it advances
when its rank calls ``test()`` or ``wait()`` on one of its requests
(``progress``, ``progress_wait``). A pass issues every runnable vertex
and re-calls every parked ``POLL`` (a device segment waiting for its
peers or for the card) once.

``wait()`` never spins holding the GIL: between passes it sleeps on the
``Doorbell`` of its comm's rendezvous, which a deposit, a segment launch
and an abort ring, for at most ``POLL_SLICE_S`` (a segment's completion on
the card rings nothing: the slice bounds how late a waiter sees it).
This is the port's analog of the JAX engine's doorbell.

Pvars, as the JAX engine keeps them: ``nbc_scheds_active`` (a level),
``nbc_vertices_issued``, ``nbc_wakeups`` (waits a doorbell ring ended:
the JAX engine counts its completion wakeups) and ``nbc_futile_polls``.
Under MV2T_TRACE the ``nbc`` lane carries ``sched_start``,
``vertex_issue``, ``vertex_complete`` and ``sched_complete`` with the JAX
fields, so the JAX package's ``bin/mv2tconform`` reads them through its
NBC automaton.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ... import mpit
from ...core.errors import MPI_ERR_INTERN, MPIException
from ...core.request import Request
from .dag import CALL, POLL, SchedDAG

# the longest a waiter sleeps between two progress passes (seconds)
POLL_SLICE_S = 2e-4

_pv_active = mpit.pvar("nbc_scheds_active", mpit.PVAR_CLASS_LEVEL,
                       "nonblocking-collective schedules in flight (all "
                       "ranks in this process)")
_pv_issued = mpit.pvar("nbc_vertices_issued", mpit.PVAR_CLASS_COUNTER,
                       "schedule vertices issued (local calls and polls)")
_pv_wakeups = mpit.pvar("nbc_wakeups", mpit.PVAR_CLASS_COUNTER,
                        "waits between progress passes that a doorbell "
                        "ring (a deposit, a launch, an abort) ended")
_pv_futile = mpit.pvar("nbc_futile_polls", mpit.PVAR_CLASS_COUNTER,
                       "progress passes that found active schedules but "
                       "advanced none")


class Doorbell:
    """A condition with a ring counter: ``ring`` wakes every sleeper;
    ``sleep(seen, timeout)`` returns at once if a ring came after the
    caller read ``rings`` as ``seen``, so no ring between a pass and the
    sleep is lost."""

    def __init__(self):
        self.cond = threading.Condition()
        self.rings = 0

    def ring(self) -> None:
        with self.cond:
            self.rings += 1
            self.cond.notify_all()

    def sleep(self, seen: int, timeout: float) -> bool:
        """True when a ring came since ``seen`` (before or during the
        sleep), False when the timeout ended it."""
        with self.cond:
            if self.rings == seen:
                self.cond.wait(timeout)
            return self.rings != seen


class _SchedState:
    """One in-flight schedule: its runtime dependency counters."""

    __slots__ = ("dag", "req", "remaining", "ndeps", "ready", "polling",
                 "advancing", "done")

    def __init__(self, dag: SchedDAG, engine, kind: str):
        self.dag = dag
        self.req = Request(engine, kind)
        self.remaining = len(dag.vertices)
        self.ndeps = [v.ndeps for v in dag.vertices]
        self.ready: List[int] = dag.roots()
        self.polling: Dict[int, object] = {}     # vid -> parked poll fn
        self.advancing = False
        self.done = False


class NbcEngine:
    """One rank's schedule queue. ``u`` is the rank's Universe (its
    recorder is ``u.tracer``); ``bell`` the doorbell of the rendezvous its
    bound comm meets at (``coll/device.py`` ``bind_universes``)."""

    def __init__(self, u=None):
        self.u = u
        self.mutex = threading.RLock()
        self.bell = Doorbell()
        self.active: List[_SchedState] = []
        self._gen = 0        # bumped on every advancement (issue/complete)
        self._seen_gen = 0   # the pass-side watermark for futile polls

    @property
    def tracer(self):
        return self.u.tracer if self.u is not None else None

    # -- entry point ------------------------------------------------------
    def start(self, dag: SchedDAG, kind: str = "nbc-coll") -> Request:
        st = _SchedState(dag, self, kind)
        st.req._cancel_fn = lambda: self._cancel(st)
        with self.mutex:
            if not dag.vertices:
                st.done = True
                st.req.complete()
                return st.req
            self.active.append(st)
            _pv_active.inc()
            if (tr := self.tracer) is not None:
                tr.record("nbc", "sched_start", "i", sched=st.req.req_id,
                          kind=kind, vertices=len(dag.vertices))
            self._advance(st)
        return st.req

    def complete_request(self, req: Request) -> None:
        with self.mutex:
            req._fire()

    # -- advancement (mutex held on every path) ---------------------------
    def _advance(self, st: _SchedState) -> None:
        """Issue every runnable vertex; vertices that a completion makes
        runnable during the loop are picked up by it."""
        if st.advancing or st.done:
            return
        st.advancing = True
        try:
            while st.ready and not st.done:
                batch = sorted(st.ready,
                               key=lambda vid: st.dag.vertices[vid].kind)
                st.ready = []
                for vid in batch:
                    if st.done:
                        break
                    self._issue(st, vid)
        finally:
            st.advancing = False
        if not st.done and st.remaining == 0:
            self._complete(st, None)

    def _issue(self, st: _SchedState, vid: int) -> None:
        v = st.dag.vertices[vid]
        _pv_issued.inc()
        self._gen += 1
        if (tr := self.tracer) is not None:
            tr.record("nbc", "vertex_issue", "i", sched=st.req.req_id,
                      vid=vid, kind=v.kind)
        if v.kind == CALL:
            try:
                v.fn()
            except MPIException as e:
                self._complete(st, e)
                return
            except Exception as e:   # noqa: BLE001 - surfaced at wait()
                self._complete(st, _intern("local op", e))
                return
            self._vertex_done(st, vid)
            return
        assert v.kind == POLL
        # first poll at issue time (a segment may complete at once, as on
        # the CPU); an incomplete poll parks until a later pass
        if not self._poll_one(st, vid, v.fn):
            st.polling[vid] = v.fn

    def _poll_one(self, st: _SchedState, vid: int, fn) -> bool:
        """Run one poll. True = the vertex completed (or the schedule
        died); False = still pending, keep it parked."""
        try:
            done = bool(fn())
        except MPIException as e:
            self._complete(st, e)
            return True
        except Exception as e:   # noqa: BLE001 - surfaced at wait()
            self._complete(st, _intern("poll op", e))
            return True
        if not done:
            return False
        st.polling.pop(vid, None)
        self._vertex_done(st, vid)
        return True

    def _vertex_done(self, st: _SchedState, vid: int) -> None:
        if (tr := self.tracer) is not None:
            tr.record("nbc", "vertex_complete", "i", sched=st.req.req_id,
                      vid=vid)
        st.remaining -= 1
        for w in st.dag.vertices[vid].out:
            st.ndeps[w] -= 1
            if st.ndeps[w] == 0:
                st.ready.append(w)
        self._gen += 1

    def _complete(self, st: _SchedState,
                  error: Optional[MPIException]) -> None:
        st.done = True
        if (tr := self.tracer) is not None:
            tr.record("nbc", "sched_complete", "i", sched=st.req.req_id,
                      error=error is not None)
        self._retire(st)
        st.req.complete(error)

    def _retire(self, st: _SchedState) -> None:
        try:
            self.active.remove(st)
            _pv_active.inc(-1)
        except ValueError:
            pass
        st.polling.clear()     # parked device segments: nothing leaks

    def _cancel(self, st: _SchedState) -> bool:
        """A user's cancel of the schedule's request: abandon what is not
        issued; succeeds only while the schedule is incomplete."""
        with self.mutex:
            if st.done:
                return False
            st.done = True
            self._retire(st)
            return True

    # -- progress ---------------------------------------------------------
    def progress(self) -> bool:
        """One pass over the active schedules: re-call every parked poll,
        issue what became runnable. True when it advanced anything."""
        with self.mutex:
            if not self.active:
                return False
            did = False
            for st in list(self.active):
                for vid, fn in list(st.polling.items()):
                    if st.done:
                        break
                    if self._poll_one(st, vid, fn):
                        did = True
                if st.done:
                    continue
                if st.ready and not st.advancing:
                    self._advance(st)
                    did = True
                elif st.remaining == 0:
                    self._complete(st, None)
                    did = True
            if self._gen != self._seen_gen:
                self._seen_gen = self._gen
                return did
            _pv_futile.inc()
            return False

    def progress_wait(self, pred) -> None:
        """Progress until ``pred()`` holds, sleeping on the doorbell
        between passes (the GIL released)."""
        while True:
            seen = self.bell.rings
            self.progress()
            if pred():
                return
            if self.bell.sleep(seen, POLL_SLICE_S):
                _pv_wakeups.inc()


def _intern(what: str, e: BaseException) -> MPIException:
    err = MPIException(MPI_ERR_INTERN, f"schedule {what} failed: {e!r}")
    err.__cause__ = e
    return err


def start(comm, dag: SchedDAG, kind: str = "nbc-coll") -> Request:
    """Launch ``dag`` on the engine of ``comm``'s universe."""
    return comm.u.engine.start(dag, kind)
