"""Tag matching: posted and unexpected receive queues (a copy of the JAX
package's ``pt2pt/matching.py``).

One matcher a rank; the match key is (context id, source rank in the
comm, tag) with MPI's wildcards, FIFO per envelope for MPI's
non-overtaking rule. Pvars: ``recvq_match_attempts``,
``recvq_unexpected_hwm`` and ``recvq_posted_hwm``.
"""

from __future__ import annotations

import collections
from typing import Optional

from ..core.status import ANY_SOURCE, ANY_TAG
from ..transport.base import Packet
from .. import mpit

# process-wide matching pvars
_pv_attempts = mpit.pvar("recvq_match_attempts", mpit.PVAR_CLASS_COUNTER,
                         "envelope match attempts")
_pv_unexp_hwm = mpit.pvar("recvq_unexpected_hwm",
                          mpit.PVAR_CLASS_HIGHWATERMARK,
                          "unexpected-queue length high watermark")
_pv_posted_hwm = mpit.pvar("recvq_posted_hwm",
                           mpit.PVAR_CLASS_HIGHWATERMARK,
                           "posted-queue length high watermark")


class Matcher:
    def __init__(self):
        self.posted: collections.deque = collections.deque()     # RecvRequest
        self.unexpected: collections.deque = collections.deque() # Packet
        # pvars (SURVEY §5.1)
        self.posted_hwm = 0
        self.unexpected_hwm = 0
        self.match_attempts = 0

    # -- incoming message path -------------------------------------------
    def match_incoming(self, pkt: Packet):
        """Find & remove the first posted recv matching this envelope."""
        self.match_attempts += 1
        _pv_attempts.inc()
        for req in self.posted:
            m = req.match
            if m[0] != pkt.ctx:
                continue
            if m[1] != ANY_SOURCE and m[1] != pkt.comm_src:
                continue
            if m[2] != ANY_TAG and m[2] != pkt.tag:
                continue
            self.posted.remove(req)
            return req
        self.unexpected.append(pkt)
        self.unexpected_hwm = max(self.unexpected_hwm, len(self.unexpected))
        _pv_unexp_hwm.mark(self.unexpected_hwm)
        return None

    # -- posted recv path -------------------------------------------------
    def match_posted(self, ctx: int, source: int, tag: int) -> Optional[Packet]:
        """Find & remove the first unexpected message matching the recv."""
        self.match_attempts += 1
        _pv_attempts.inc()
        for pkt in self.unexpected:
            if not self._env_match(pkt, ctx, source, tag):
                continue
            self.unexpected.remove(pkt)
            return pkt
        return None

    def cancel_unexpected(self, src_world: int, sreq_id: int) -> bool:
        """Send-cancel protocol target side: retract a not-yet-matched
        message identified by (sender world rank, send request id).
        True iff it was still queued (MPI_Cancel on sends, ch3 cancel
        packet analog)."""
        for pkt in self.unexpected:
            if pkt.src_world == src_world and pkt.sreq_id == sreq_id \
                    and pkt.sreq_id != 0:
                self.unexpected.remove(pkt)
                return True
        return False

    def peek_unexpected(self, ctx: int, source: int, tag: int,
                        remove: bool = False) -> Optional[Packet]:
        """Probe support: find (optionally remove, for Mprobe) a message."""
        for pkt in self.unexpected:
            if self._env_match(pkt, ctx, source, tag):
                if remove:
                    self.unexpected.remove(pkt)
                return pkt
        return None

    @staticmethod
    def _env_match(pkt: Packet, ctx: int, source: int, tag: int) -> bool:
        if pkt.ctx != ctx:
            return False
        if source != ANY_SOURCE and pkt.comm_src != source:
            return False
        if tag != ANY_TAG and pkt.tag != tag:
            return False
        return True

    def post(self, req) -> None:
        self.posted.append(req)
        self.posted_hwm = max(self.posted_hwm, len(self.posted))
        _pv_posted_hwm.mark(self.posted_hwm)

    def cancel_posted(self, req) -> bool:
        """Remove a posted recv (MPI_Cancel); True if it was still queued."""
        try:
            self.posted.remove(req)
            return True
        except ValueError:
            return False
