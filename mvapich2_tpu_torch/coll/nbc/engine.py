"""The completion-driven scheduler of the nonblocking collectives' DAGs
(a copy of the JAX package's ``coll/nbc/engine.py``).

One ``NbcEngine`` rides each rank's ``ProgressEngine``
(``transport/progress.py``; ``nbc_engine``) as its registered progress
hook, and holds that rank's schedules in flight. A schedule advances
from request-completion callbacks: when a vertex's send or receive
completes, the callback (engine mutex held, on whichever thread
progressed the engine) marks the vertex done and issues every vertex it
made runnable, and the completion rings the engine's doorbell. The hook
is the safety net that issues what a completion path left ready, and
the pump of the device tier's parked ``POLL`` vertices (a segment
waiting for its peers or for the card), which it re-calls once a pass.

Pvars, as the JAX engine keeps them: ``nbc_scheds_active`` (a level),
``nbc_vertices_issued``, ``nbc_wakeups`` (schedule advancements an event
started: a vertex request's completion callback, or a doorbell ring that
ended a wait while a device segment was parked; the JAX engine counts
the former) and ``nbc_futile_polls``. Under MV2T_TRACE the ``nbc`` lane
carries ``sched_start``, ``vertex_issue``, ``vertex_complete`` and
``sched_complete`` with the JAX fields, so the JAX package's
``bin/mv2tconform`` reads them through its NBC automaton.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ... import mpit
from ...core.datatype import from_numpy_dtype
from ...core.errors import MPI_ERR_INTERN, MPIException
from ...core.request import Request
from .dag import CALL, POLL, RECV, SchedDAG

_pv_active = mpit.pvar("nbc_scheds_active", mpit.PVAR_CLASS_LEVEL,
                       "nonblocking-collective schedules in flight (all "
                       "ranks in this process)")
_pv_issued = mpit.pvar("nbc_vertices_issued", mpit.PVAR_CLASS_COUNTER,
                       "schedule vertices issued (sends, recvs, local "
                       "calls, polls)")
_pv_wakeups = mpit.pvar("nbc_wakeups", mpit.PVAR_CLASS_COUNTER,
                        "schedule advancements an event started: a vertex "
                        "completion, or a doorbell ring ending a wait on "
                        "a parked device segment")
_pv_futile = mpit.pvar("nbc_futile_polls", mpit.PVAR_CLASS_COUNTER,
                       "progress passes that found active schedules but "
                       "advanced none")


class _SchedState:
    """One in-flight schedule: its runtime dependency counters and
    requests."""

    __slots__ = ("dag", "req", "remaining", "ndeps", "ready", "inflight",
                 "polling", "advancing", "done")

    def __init__(self, dag: SchedDAG, engine, kind: str):
        self.dag = dag
        self.req = Request(engine, kind)
        self.remaining = len(dag.vertices)
        self.ndeps = [v.ndeps for v in dag.vertices]
        self.ready: List[int] = dag.roots()
        self.inflight: Dict[int, Request] = {}   # vid -> vertex request
        self.polling: Dict[int, object] = {}     # vid -> parked poll fn
        self.advancing = False
        self.done = False


class NbcEngine:
    """One rank's schedule queue: the hook of its ProgressEngine
    (``engine``)."""

    def __init__(self, engine):
        self.engine = engine
        self.active: List[_SchedState] = []
        self._gen = 0        # bumped on every advancement (issue/complete)
        self._seen_gen = 0   # the hook's watermark for futile polls
        engine.register_hook(self._hook)

    # -- entry point ------------------------------------------------------
    def start(self, dag: SchedDAG, kind: str = "nbc-coll") -> Request:
        eng = self.engine
        st = _SchedState(dag, eng, kind)
        st.req._cancel_fn = lambda: self._cancel(st)
        with eng.mutex:
            if not dag.vertices:
                st.done = True
                st.req.complete()
                return st.req
            self.active.append(st)
            _pv_active.inc()
            if (tr := eng.tracer) is not None:
                tr.record("nbc", "sched_start", "i", sched=st.req.req_id,
                          kind=kind, vertices=len(dag.vertices))
            self._advance(st)
        return st.req

    def has_parked_polls(self) -> bool:
        """True while a device segment is parked (its completion on the
        card rings no doorbell)."""
        return any(st.polling for st in self.active)

    def note_wakeup(self) -> None:
        """A doorbell ring ended a wait (``ProgressEngine.progress_wait``):
        counted while a schedule is in flight."""
        if self.active:
            _pv_wakeups.inc()

    # -- advancement (engine mutex held on every path) --------------------
    def _advance(self, st: _SchedState) -> None:
        """Issue every runnable vertex. Completions inside an issue (an
        eager send, an already matched receive) land in ``st.ready`` and
        are picked up by the outer loop."""
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
        if (tr := self.engine.tracer) is not None:
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
        if v.kind == POLL:
            # first poll at issue time (a segment may complete at once, as
            # on the CPU); an incomplete poll parks until a later pass
            if not self._poll_one(st, vid, v.fn):
                st.polling[vid] = v.fn
            return
        comm, buf = v.comm, v.buf
        proto = comm.u.protocol
        try:
            if v.kind == RECV:
                req = proto.irecv(buf, buf.size,
                                  from_numpy_dtype(buf.dtype), v.peer,
                                  comm.ctx_coll, v.tag)
            else:
                req = proto.isend(buf, buf.size,
                                  from_numpy_dtype(buf.dtype),
                                  comm.world_of(v.peer), comm.rank,
                                  comm.ctx_coll, v.tag)
        except MPIException as e:
            self._complete(st, e)
            return
        if req.complete_flag:
            if req.error is not None:
                self._complete(st, req.error)
                return
            self._vertex_done(st, vid)
            return
        st.inflight[vid] = req
        req.add_callback(
            lambda r, st=st, vid=vid: self._on_completion(st, vid, r))

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
        if (tr := self.engine.tracer) is not None:
            tr.record("nbc", "vertex_complete", "i", sched=st.req.req_id,
                      vid=vid)
        st.remaining -= 1
        st.inflight.pop(vid, None)
        for w in st.dag.vertices[vid].out:
            st.ndeps[w] -= 1
            if st.ndeps[w] == 0:
                st.ready.append(w)
        self._gen += 1

    def _on_completion(self, st: _SchedState, vid: int,
                       req: Request) -> None:
        """A vertex request's completion callback (engine mutex held, from
        ``ProgressEngine.complete_request``): the event edge that
        advances the schedule."""
        if st.done:
            return
        _pv_wakeups.inc()
        if req.error is not None:
            self._complete(st, req.error)
            return
        self._vertex_done(st, vid)
        self._advance(st)
        if not st.done and st.remaining == 0:
            self._complete(st, None)

    def _complete(self, st: _SchedState,
                  error: Optional[MPIException]) -> None:
        st.done = True
        if (tr := self.engine.tracer) is not None:
            tr.record("nbc", "sched_complete", "i", sched=st.req.req_id,
                      error=error is not None)
        self._retire(st, cancel_inflight=error is not None)
        st.req.complete(error)

    def _retire(self, st: _SchedState, cancel_inflight: bool) -> None:
        try:
            self.active.remove(st)
            _pv_active.inc(-1)
        except ValueError:
            pass
        if cancel_inflight:
            # unwind: posted receives leave the matching queue, unmatched
            # sends are retracted through the cancel protocol
            for req in list(st.inflight.values()):
                try:
                    req.cancel()
                except MPIException:
                    pass
        st.inflight.clear()
        st.polling.clear()     # parked device segments: nothing leaks

    def _cancel(self, st: _SchedState) -> bool:
        """A user's cancel of the schedule's request: abandon what is not
        issued and cancel what is in flight; succeeds only while the
        schedule is incomplete."""
        with self.engine.mutex:
            if st.done:
                return False
            st.done = True
            self._retire(st, cancel_inflight=True)
            return True

    # -- the progress hook (mutex held, from progress_poke) ---------------
    def _hook(self) -> bool:
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


def _intern(what: str, e: BaseException) -> MPIException:
    err = MPIException(MPI_ERR_INTERN, f"schedule {what} failed: {e!r}")
    err.__cause__ = e
    return err


def nbc_engine(engine) -> NbcEngine:
    """The progress engine's scheduler, made on first use."""
    nbc = engine.nbc
    if nbc is None:
        with engine.mutex:
            nbc = engine.nbc
            if nbc is None:
                nbc = engine.nbc = NbcEngine(engine)
    return nbc


def start(comm, dag: SchedDAG, kind: str = "nbc-coll") -> Request:
    """Launch ``dag`` on the progress engine of ``comm``'s universe."""
    return nbc_engine(comm.u.engine).start(dag, kind)
