"""Eager and rendezvous protocol state machines (a trimmed copy of the
JAX package's ``pt2pt/protocol.py``).

* eager: the payload rides the first packet and the sender completes
  locally; a message of at most SMP_EAGERSIZE bytes (32 KiB) to a rank
  of the same node, or EAGER_THRESHOLD bytes (64 KiB) to a rank of
  another (``nodes=`` of ``run_ranks``), goes eager;
* rendezvous: RGET (the default) exposes the packed send buffer and the
  receiver pulls it once it matches, then answers FIN (over shared
  memory the channel's handle ladder: CMA, the arena, a file,
  ``transport/shm.py``); RPUT and R3 stage the receive, send CTS, and
  the sender pushes DATA chunks of R3_CHUNK_SIZE bytes. Ssend always
  takes it, so its completion implies the match;
* the pipelined arena rendezvous (APIPE), where a shared-memory channel
  has the node's arena and no CMA and the message spans two
  ``RNDV_CHUNK`` chunks or more: the sender copies the first chunks into
  a block of slots of the arena and sends an RTS naming it; the
  receiver drains every published chunk, then answers one AACK with the
  highest chunk consumed; the sender refills the freed slots and answers
  one APUB with the new frontier; the last drain answers FIN, which
  frees the block;
* probe, iprobe, improbe/mrecv, and cancel (a posted receive leaves the
  matching queue; a send, eager or rendezvous, is retracted from the
  peer's unexpected queue by the CANCEL_SEND_REQ/RESP exchange).

Pvars: ``pt2pt_eager_sent``, ``pt2pt_rndv_sent`` and
``pt2pt_bytes_sent``; ``rndv_pipeline_chunks`` (``transport/arena.py``).
Under MV2T_TRACE a chunk batch of APIPE drops a ``protocol``-lane
``rndv_chunk`` instant (``dir`` pub or drain), as a CMA pull does a
chunk. Not ported: the native plane's requests and the ULFM failure
checks; a thread rank's channel is the in-process fabric
(``transport/local.py``), where no rung of the shared-memory ladder is
taken.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import mpit
from ..core import datatype as dtmod
from ..core.datatype import Datatype, as_bytes_view
from ..core.errors import (MPI_ERR_ARG, MPI_ERR_INTERN, MPI_ERR_TRUNCATE,
                           MPIException, mpi_assert)
from ..core.request import CompletedRequest, Request
from ..core.status import ANY_TAG, PROC_NULL, Status
from ..transport import arena as arena_mod
from ..transport.base import Packet, PktType
from ..utils.config import get_config
from .matching import Matcher

_pv_eager = mpit.pvar("pt2pt_eager_sent", mpit.PVAR_CLASS_COUNTER,
                      "messages sent on the eager path")
_pv_rndv = mpit.pvar("pt2pt_rndv_sent", mpit.PVAR_CLASS_COUNTER,
                     "messages sent on the rendezvous path")
_pv_bytes = mpit.pvar("pt2pt_bytes_sent", mpit.PVAR_CLASS_COUNTER,
                      "total payload bytes sent")


class SendRequest(Request):
    def __init__(self, engine, dest_world: int):
        super().__init__(engine, "send")
        self.dest_world = dest_world
        self.packed: Optional[np.ndarray] = None
        self.handle = None
        self.channel = None
        self.protocol = ""

    def cancel(self) -> None:
        """A locally complete eager or buffered send is still cancellable
        until the receiver has matched it (MPI-3.1 §3.8.4); the outcome
        arrives with the CANCEL_SEND_RESP packet."""
        fn = self._cancel_fn
        if fn is None or self.cancelled \
                or getattr(self, "_cancel_pending", False):
            return
        fn()


class RecvRequest(Request):
    def __init__(self, engine, match: Tuple[int, int, int], buf, count: int,
                 datatype: Datatype):
        super().__init__(engine, "recv")
        self.match = match      # (ctx, source, tag)
        self.buf = buf
        self.count = count
        self.datatype = datatype
        self.scratch: Optional[np.ndarray] = None

    @property
    def capacity(self) -> int:
        return self.datatype.size * self.count


class Pt2ptProtocol:
    """One rank's protocol instance, bound to its progress engine."""

    def __init__(self, universe):
        self.u = universe
        self.engine = universe.engine
        self.matcher = Matcher()
        eng = self.engine
        eng.register_handler(PktType.EAGER_SEND, self._on_eager)
        eng.register_handler(PktType.RNDV_RTS, self._on_rts)
        eng.register_handler(PktType.RNDV_CTS, self._on_cts)
        eng.register_handler(PktType.RNDV_DATA, self._on_data)
        eng.register_handler(PktType.RNDV_FIN, self._on_fin)
        eng.register_handler(PktType.RNDV_APUB, self._on_apipe_pub)
        eng.register_handler(PktType.RNDV_AACK, self._on_apipe_ack)
        eng.register_handler(PktType.CANCEL_SEND_REQ, self._on_cancel_req)
        eng.register_handler(PktType.CANCEL_SEND_RESP,
                             self._on_cancel_resp)
        self.cfg = get_config()

    # ------------------------------------------------------------------
    # send side
    # ------------------------------------------------------------------
    def isend(self, buf, count: int, datatype: Datatype, dest_world: int,
              comm_src: int, ctx: int, tag: int,
              mode: str = "standard") -> Request:
        """Start a send; returns the request (already complete for eager)."""
        if dest_world == PROC_NULL:
            return CompletedRequest()
        channel = self.u.channel_for(dest_world)
        nbytes = datatype.size * count
        threshold = (self.cfg["SMP_EAGERSIZE"]
                     if self.u.is_local(dest_world)
                     else self.cfg["EAGER_THRESHOLD"])

        if mode == "buffered":
            # MPI_Bsend: copy now, complete at once; the transfer proceeds
            # on a shadow request, and a cancel resolves through it
            shadow = self.isend(np.asarray(datatype.pack(buf, count)),
                                nbytes, dtmod.BYTE, dest_world, comm_src,
                                ctx, tag, "standard")
            breq = SendRequest(self.engine, dest_world)
            breq._fire()
            if isinstance(shadow, SendRequest):
                def bcancel():
                    with self.engine.mutex:
                        if getattr(breq, "_cancel_pending", False):
                            return False
                        breq._cancel_pending = True
                        breq.complete_flag = False
                    shadow.cancel()

                    def on_shadow(sr):
                        breq.cancelled = bool(sr.cancelled)
                        breq.status.cancelled = breq.cancelled
                        breq.complete()
                    shadow.add_callback(on_shadow)
                    return False
                breq._cancel_fn = bcancel
            return breq

        if nbytes <= threshold and mode != "sync":
            if datatype.is_contiguous:
                # zero-copy injection: the channel copies the payload
                # before it returns, so a view keeps eager buffer reuse
                mv = as_bytes_view(buf)
                mpi_assert(len(mv) >= nbytes, MPI_ERR_ARG,
                           f"buffer too small: {len(mv)} < {nbytes}")
                packed = mv[:nbytes]
            else:
                packed = np.asarray(datatype.pack(buf, count))
            sreq = SendRequest(self.engine, dest_world)
            pkt = Packet(PktType.EAGER_SEND, self.u.world_rank, ctx,
                         comm_src, tag, nbytes, packed,
                         sreq_id=sreq.req_id)
            channel.send_packet(dest_world, pkt)
            _pv_eager.inc()
            _pv_bytes.inc(nbytes)
            # locally complete, but cancellable until matched (§3.8.4)
            sreq._fire()
            sreq._cancel_fn = lambda: self._cancel_send(
                sreq, dest_world, channel)
            return sreq

        # rendezvous (always for Ssend, so completion implies matching)
        sreq = SendRequest(self.engine, dest_world)
        sreq.channel = channel
        sreq.packed = np.asarray(datatype.pack(buf, count))
        proto = self.cfg["RNDV_PROTOCOL"]
        if proto == "RGET" and self._start_apipe(
                sreq, channel, dest_world, ctx, comm_src, tag, nbytes):
            return sreq
        if proto == "RGET" and channel.supports_rget:
            sreq.protocol = "RGET"
            sreq.handle = channel.expose_buffer(sreq.packed)
        else:
            sreq.protocol = "RPUT"
        with self.engine.mutex:
            self.engine.track(sreq)
        pkt = Packet(PktType.RNDV_RTS, self.u.world_rank, ctx, comm_src,
                     tag, nbytes, None, sreq_id=sreq.req_id,
                     protocol=sreq.protocol,
                     extra={"handle": sreq.handle}
                     if sreq.handle is not None else None)
        channel.send_packet(dest_world, pkt)
        # MPI_Cancel on an unmatched rendezvous send retracts the RTS
        # from the peer's unexpected queue; the RESP completes it
        sreq._cancel_fn = lambda: self._cancel_send(sreq, dest_world,
                                                    channel)
        _pv_rndv.inc()
        _pv_bytes.inc(nbytes)
        return sreq

    def _cancel_send(self, sreq, dest_world: int, channel) -> bool:
        """Start a send-cancel; the RESP resolves it. A locally complete
        eager send is held incomplete until then, so MPI_Wait sees the
        cancel's outcome."""
        eng = self.engine
        with eng.mutex:
            if sreq.cancelled or getattr(sreq, "_cancel_pending", False):
                return False
            sreq._cancel_pending = True
            sreq._cancel_was_complete = sreq.complete_flag
            sreq.complete_flag = False
            eng.outstanding[sreq.req_id] = sreq
        pkt = Packet(PktType.CANCEL_SEND_REQ, self.u.world_rank,
                     sreq_id=sreq.req_id)
        channel.send_packet(dest_world, pkt)
        return False

    def _on_cancel_req(self, pkt: Packet) -> None:
        ok = self.matcher.cancel_unexpected(pkt.src_world, pkt.sreq_id)
        resp = Packet(PktType.CANCEL_SEND_RESP, self.u.world_rank,
                      sreq_id=pkt.sreq_id, offset=1 if ok else 0)
        self.u.channel_for(pkt.src_world).send_packet(pkt.src_world, resp)

    def _on_cancel_resp(self, pkt: Packet) -> None:
        sreq = self.engine.outstanding.get(pkt.sreq_id)
        if sreq is None or sreq.complete_flag:
            return            # already completed normally: not cancelled
        if pkt.offset:        # retracted at the target
            sreq.cancelled = True
            sreq.status.cancelled = True
            self._release_send_side(sreq)
            sreq.complete()
        elif getattr(sreq, "_cancel_was_complete", False):
            sreq.complete()   # restore the eager local completion
        # else: an in-flight rendezvous completes through its FIN

    # ------------------------------------------------------------------
    # recv side
    # ------------------------------------------------------------------
    def irecv(self, buf, count: int, datatype: Datatype, source: int,
              ctx: int, tag: int) -> Request:
        if source == PROC_NULL:
            req = CompletedRequest()
            req.status.source = PROC_NULL
            req.status.tag = ANY_TAG
            return req
        req = RecvRequest(self.engine, (ctx, source, tag), buf, count,
                          datatype)
        with self.engine.mutex:
            pkt = self.matcher.match_posted(ctx, source, tag)
            if pkt is not None:
                self._deliver(req, pkt)
            else:
                self.matcher.post(req)
                req._cancel_fn = lambda: self.matcher.cancel_posted(req)
        return req

    # -- probe ----------------------------------------------------------
    def iprobe(self, source: int, ctx: int, tag: int) -> Optional[Status]:
        with self.engine.mutex:
            pkt = self.matcher.peek_unexpected(ctx, source, tag)
        if pkt is None:
            self.engine.progress_poke()
            with self.engine.mutex:
                pkt = self.matcher.peek_unexpected(ctx, source, tag)
        return self._pkt_status(pkt) if pkt is not None else None

    def probe(self, source: int, ctx: int, tag: int) -> Status:
        box: list = []

        def pred():
            pkt = self.matcher.peek_unexpected(ctx, source, tag)
            if pkt is not None:
                box.append(pkt)
                return True
            return False

        self.engine.progress_wait(pred)
        return self._pkt_status(box[0])

    def improbe(self, source: int, ctx: int, tag: int):
        """A matched-message token (the packet), or None."""
        with self.engine.mutex:
            pkt = self.matcher.peek_unexpected(ctx, source, tag, remove=True)
        if pkt is None:
            self.engine.progress_poke()
            with self.engine.mutex:
                pkt = self.matcher.peek_unexpected(ctx, source, tag,
                                                   remove=True)
        return pkt

    def mrecv(self, message, buf, count: int,
              datatype: Datatype) -> Request:
        req = RecvRequest(self.engine, (message.ctx, message.comm_src,
                                        message.tag), buf, count, datatype)
        with self.engine.mutex:
            self._deliver(req, message)
        return req

    @staticmethod
    def _pkt_status(pkt: Packet) -> Status:
        return Status(source=pkt.comm_src, tag=pkt.tag, count=pkt.nbytes)

    # ------------------------------------------------------------------
    # delivery / handlers (engine mutex held)
    # ------------------------------------------------------------------
    def _deliver(self, req: RecvRequest, pkt: Packet) -> None:
        if pkt.type == PktType.EAGER_SEND:
            self._deliver_eager(req, pkt)
        elif pkt.type == PktType.RNDV_RTS:
            self._rndv_recv_start(req, pkt)
        else:  # pragma: no cover
            raise MPIException(MPI_ERR_INTERN, f"bad matched pkt {pkt.type}")

    def _finish_recv(self, req: RecvRequest, nbytes: int, src: int,
                     tag: int) -> None:
        req.status.source = src
        req.status.tag = tag
        req.status.count = min(nbytes, req.capacity)
        err = None
        if nbytes > req.capacity:
            err = MPIException(MPI_ERR_TRUNCATE,
                               f"message truncated: {nbytes} > {req.capacity}")
        req.complete(err)

    def _deliver_eager(self, req: RecvRequest, pkt: Packet) -> None:
        n = min(pkt.nbytes, req.capacity)
        if n > 0 and req.buf is not None:
            req.datatype.unpack(pkt.data[:n], req.buf, req.count)
        self._finish_recv(req, pkt.nbytes, pkt.comm_src, pkt.tag)

    def _rndv_recv_start(self, req: RecvRequest, pkt: Packet) -> None:
        src_world = pkt.src_world
        channel = self.u.channel_for(src_world)
        if pkt.protocol == "APIPE":
            self._apipe_recv_start(req, pkt)
            return
        if pkt.protocol == "RGET":
            n = min(pkt.nbytes, req.capacity)
            if n > 0:
                data = channel.pull_buffer(src_world, pkt.extra["handle"], n)
                req.datatype.unpack(data, req.buf, req.count)
            fin = Packet(PktType.RNDV_FIN, self.u.world_rank,
                         sreq_id=pkt.sreq_id)
            channel.send_packet(src_world, fin)
            self._finish_recv(req, pkt.nbytes, pkt.comm_src, pkt.tag)
            return
        # RPUT/R3: stage into scratch, ask the sender to push
        req.scratch = np.empty(min(pkt.nbytes, req.capacity), dtype=np.uint8)
        req._rndv_env = (pkt.comm_src, pkt.tag, pkt.nbytes)
        self.engine.track(req)
        cts = Packet(PktType.RNDV_CTS, self.u.world_rank,
                     sreq_id=pkt.sreq_id, rreq_id=req.req_id)
        channel.send_packet(src_world, cts)

    def _on_eager(self, pkt: Packet) -> None:
        req = self.matcher.match_incoming(pkt)
        if req is not None:
            self._deliver_eager(req, pkt)

    def _on_rts(self, pkt: Packet) -> None:
        req = self.matcher.match_incoming(pkt)
        if req is not None:
            self._rndv_recv_start(req, pkt)

    def _on_cts(self, pkt: Packet) -> None:
        sreq = self.engine.outstanding.get(pkt.sreq_id)
        if sreq is None:  # pragma: no cover
            raise MPIException(MPI_ERR_INTERN, "CTS for unknown send")
        data = sreq.packed
        chunk = self.cfg["R3_CHUNK_SIZE"]
        total = len(data)
        off = 0
        while True:
            end = min(off + chunk, total)
            dpkt = Packet(PktType.RNDV_DATA, self.u.world_rank,
                          nbytes=end - off, data=data[off:end],
                          rreq_id=pkt.rreq_id, offset=off,
                          extra={"last": end >= total})
            sreq.channel.send_packet(pkt.src_world, dpkt)
            off = end
            if off >= total:
                break
        sreq.complete()

    def _on_data(self, pkt: Packet) -> None:
        rreq = self.engine.outstanding.get(pkt.rreq_id)
        if rreq is None:  # pragma: no cover
            raise MPIException(MPI_ERR_INTERN, "DATA for unknown recv")
        cap = len(rreq.scratch)
        if pkt.offset < cap and pkt.nbytes > 0:
            n = min(pkt.nbytes, cap - pkt.offset)
            rreq.scratch[pkt.offset:pkt.offset + n] = pkt.data[:n]
        if pkt.extra and pkt.extra.get("last"):
            if cap > 0:
                rreq.datatype.unpack(rreq.scratch, rreq.buf, rreq.count)
            src, tag, nbytes = rreq._rndv_env
            self._finish_recv(rreq, nbytes, src, tag)

    def _on_fin(self, pkt: Packet) -> None:
        sreq = self.engine.outstanding.get(pkt.sreq_id)
        if sreq is None:  # pragma: no cover
            raise MPIException(MPI_ERR_INTERN, "FIN for unknown send")
        self._release_send_side(sreq)
        sreq.complete()

    def _release_send_side(self, sreq) -> None:
        """Free the send side of a rendezvous (the APIPE block, the
        exposure handle) on FIN or a successful cancel."""
        ap = getattr(sreq, "_ap", None)
        if ap is not None:
            ap["arena"].free(ap["block"])
            sreq._ap = None
        if sreq.handle is not None and sreq.channel is not None:
            sreq.channel.release_buffer(sreq.handle)
            sreq.handle = None

    # ------------------------------------------------------------------
    # the pipelined arena rendezvous (APIPE): the sender copies chunk k+1
    # into arena slots while the receiver drains chunk k, the RGET
    # pipelining of gen2/ibv_rndv.c over the node's arena. Flow control
    # is batched: the receiver drains every published chunk, then sends
    # one AACK with the highest chunk consumed; the sender refills every
    # slot it freed and answers one APUB with the new frontier.
    # ------------------------------------------------------------------
    def _start_apipe(self, sreq, channel, dest_world: int, ctx: int,
                     comm_src: int, tag: int, nbytes: int) -> bool:
        """Start the pipelined rendezvous where the channel's arena is
        agreed, CMA is not, and the message spans two chunks or more;
        False takes the one-shot RGET ladder."""
        arena = getattr(channel, "arena", None)
        if arena is None or not getattr(channel, "_arena_ready", False) \
                or getattr(channel, "cma_ok", False):
            return False
        chunk = self.cfg["RNDV_CHUNK"]
        depth = max(2, self.cfg["RNDV_DEPTH"])
        if chunk <= 0 or nbytes < 2 * chunk:
            return False
        nchunks = (nbytes + chunk - 1) // chunk
        # the window: the whole message when it fits 1/16 of the
        # partition (RTS and FIN only), else at least the depth; one
        # block of slots, chunk k in slot k % nslots
        want = min(nchunks, max(depth, arena.part_bytes // 16 // chunk))
        block = None
        while want >= 2:
            block = arena.alloc(want * chunk)
            if block is not None:
                break
            want //= 2              # a fuller arena: a shallower pipeline
        if block is None:           # exhausted: the one-shot ladder
            return False
        nslots = want
        d0 = min(nslots, nchunks)
        data = np.ascontiguousarray(sreq.packed).view(np.uint8).reshape(-1)
        tr = self.engine.tracer
        span0 = min(d0 * chunk, nbytes)
        arena.view(block.off, span0)[:] = data[:span0]
        arena_mod.pv_pipeline.inc(d0)
        if tr is not None:
            tr.record("protocol", "rndv_chunk", "i", dir="pub", k=0,
                      chunks=d0, bytes=span0)
        sreq.protocol = "APIPE"
        sreq._ap = {"block": block, "arena": arena, "chunk": chunk,
                    "nslots": nslots, "nchunks": nchunks, "next": d0,
                    "data": data}
        with self.engine.mutex:
            self.engine.track(sreq)
        pkt = Packet(PktType.RNDV_RTS, self.u.world_rank, ctx, comm_src,
                     tag, nbytes, None, sreq_id=sreq.req_id,
                     protocol="APIPE",
                     extra={"block": block.off, "chunk": chunk,
                            "nslots": nslots, "pub": d0})
        channel.send_packet(dest_world, pkt)
        sreq._cancel_fn = lambda: self._cancel_send(sreq, dest_world,
                                                    channel)
        _pv_rndv.inc()
        _pv_bytes.inc(nbytes)
        return True

    def _apipe_recv_start(self, req: RecvRequest, pkt: Packet) -> None:
        """The receiver's side (engine mutex held): drain straight into
        a contiguous receive buffer (a derived datatype stages and
        unpacks at the end), consume the chunks the RTS says are
        published, and acknowledge the batch."""
        channel = self.u.channel_for(pkt.src_world)
        total = pkt.nbytes
        cap = req.capacity
        n = min(total, cap)
        view = None
        if n > 0 and req.buf is not None and req.datatype.is_contiguous:
            try:
                view = np.frombuffer(as_bytes_view(req.buf), dtype=np.uint8,
                                     count=cap)
            except (ValueError, TypeError, MPIException):
                view = None
        if view is None and n > 0:
            req.scratch = np.empty(n, dtype=np.uint8)
            view = req.scratch
        chunk = pkt.extra["chunk"]
        req._ap = {"block": pkt.extra["block"], "chunk": chunk,
                   "nslots": pkt.extra["nslots"],
                   "nchunks": (total + chunk - 1) // chunk, "drained": 0,
                   "view": view, "n": n, "src": pkt.src_world,
                   "sreq_id": pkt.sreq_id, "channel": channel,
                   "arena": channel.arena,
                   "env": (pkt.comm_src, pkt.tag, total)}
        req._rndv_env = (pkt.comm_src, pkt.tag, total)
        self.engine.track(req)
        self._apipe_drain(req, pkt.extra["pub"])

    def _apipe_drain(self, req: RecvRequest, upto: int) -> None:
        """Copy the published chunks below ``upto`` out of the slots
        (slot-contiguous runs, one copy each), then AACK the batch, or
        finish with FIN after the last chunk."""
        ap = req._ap
        tr = self.engine.tracer
        chunk, n = ap["chunk"], ap["n"]
        nslots, block = ap["nslots"], ap["block"]
        upto = min(upto, ap["nchunks"])
        k = ap["drained"]
        while k < upto:
            run = min(upto - k, nslots - (k % nslots))
            lo = k * chunk
            span = min(run * chunk, n - lo) if lo < n else 0
            if span > 0:
                off = block + (k % nslots) * chunk
                ap["view"][lo:lo + span] = ap["arena"].view(off, span)
            arena_mod.pv_pipeline.inc(run)
            if tr is not None:
                tr.record("protocol", "rndv_chunk", "i", dir="drain",
                          k=k, chunks=run, bytes=span)
            k += run
        ap["drained"] = k
        if k < ap["nchunks"]:
            ack = Packet(PktType.RNDV_AACK, self.u.world_rank,
                         sreq_id=ap["sreq_id"], rreq_id=req.req_id,
                         offset=k - 1)
            ap["channel"].send_packet(ap["src"], ack)
            return
        if req.scratch is not None and req.buf is not None and n > 0:
            req.datatype.unpack(req.scratch, req.buf, req.count)
        fin = Packet(PktType.RNDV_FIN, self.u.world_rank,
                     sreq_id=ap["sreq_id"])
        ap["channel"].send_packet(ap["src"], fin)
        src, tag, total = ap["env"]
        req._ap = None
        self._finish_recv(req, total, src, tag)

    def _on_apipe_pub(self, pkt: Packet) -> None:
        req = self.engine.outstanding.get(pkt.rreq_id)
        if req is None or getattr(req, "_ap", None) is None:
            return     # a raced completion or cancel
        self._apipe_drain(req, pkt.offset + 1)

    def _on_apipe_ack(self, pkt: Packet) -> None:
        """Refill the slots the AACK freed (chunk j reuses the slot of
        chunk j - nslots) and publish the new frontier in one APUB."""
        sreq = self.engine.outstanding.get(pkt.sreq_id)
        if sreq is None or getattr(sreq, "_ap", None) is None:
            return
        ap = sreq._ap
        chunk, nslots, block = ap["chunk"], ap["nslots"], ap["block"]
        nbytes = len(ap["data"])
        hi = min(pkt.offset + nslots + 1, ap["nchunks"])
        k = ap["next"]
        if hi <= k:
            return
        tr = self.engine.tracer
        while k < hi:
            run = min(hi - k, nslots - (k % nslots))
            lo = k * chunk
            span = min(run * chunk, nbytes - lo)
            off = block.off + (k % nslots) * chunk
            ap["arena"].view(off, span)[:] = ap["data"][lo:lo + span]
            arena_mod.pv_pipeline.inc(run)
            if tr is not None:
                tr.record("protocol", "rndv_chunk", "i", dir="pub", k=k,
                          chunks=run, bytes=span)
            k += run
        ap["next"] = hi
        pub = Packet(PktType.RNDV_APUB, self.u.world_rank,
                     rreq_id=pkt.rreq_id, offset=hi - 1)
        sreq.channel.send_packet(pkt.src_world, pub)
