"""The channel interface under the point-to-point protocol (a trimmed
copy of the JAX package's ``transport/base.py``).

A channel moves opaque packets between world ranks; the protocol layer
above it (``pt2pt/protocol.py``) implements matching and the eager and
rendezvous state machines. The port has one channel, the in-process
fabric of thread ranks (``transport/local.py``): it hands packets over by
reference, so the JAX package's wire codec (``encode_packet`` /
``decode_packet``, used by its socket and shared-memory channels) is not
ported, and neither are the packet types of the tiers that wait (the
one-sided host windows, the arena pipeline, CMA, ULFM revoke).
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Optional

import numpy as np


class PktType(enum.IntEnum):
    """Packet types, with the JAX package's numbers."""

    EAGER_SEND = 1
    RNDV_RTS = 2           # request-to-send (no payload)
    RNDV_CTS = 3           # clear-to-send (receiver matched)
    RNDV_DATA = 4          # RPUT/R3 payload chunk
    RNDV_FIN = 5           # transfer complete
    CANCEL_SEND_REQ = 33   # retract an unmatched send
    CANCEL_SEND_RESP = 34


class Packet:
    """One message. ``data`` is a contiguous uint8 ndarray or None."""

    __slots__ = ("type", "src_world", "ctx", "comm_src", "tag", "nbytes",
                 "data", "sreq_id", "rreq_id", "protocol", "offset", "extra")

    def __init__(self, type: PktType, src_world: int, ctx: int = 0,
                 comm_src: int = 0, tag: int = 0, nbytes: int = 0,
                 data: Optional[np.ndarray] = None, sreq_id: int = 0,
                 rreq_id: int = 0, protocol: str = "", offset: int = 0,
                 extra: Optional[Dict[str, Any]] = None):
        self.type = type
        self.src_world = src_world
        self.ctx = ctx
        self.comm_src = comm_src
        self.tag = tag
        self.nbytes = nbytes
        self.data = data
        self.sreq_id = sreq_id
        self.rreq_id = rreq_id
        self.protocol = protocol
        self.offset = offset
        self.extra = extra

    def __repr__(self):
        return (f"Packet({self.type.name}, src={self.src_world}, "
                f"ctx={self.ctx}, tag={self.tag}, nbytes={self.nbytes})")


class Channel:
    """The transport seam: one rank's end of a fabric. Delivery is pushed
    into the peer engine's inbox (``ProgressEngine.enqueue_incoming``),
    so a channel has nothing to poll."""

    name = "abstract"
    # True if RTS packets may carry a zero-copy handle the receiver can
    # pull from directly (the RGET path)
    supports_rget = False

    # -- traffic accounting (the JAX package's per-channel pvars) ---------
    def _acct_pvars(self):
        """The ``chan_<name>_{msgs,bytes}_sent`` counters, declared on
        first use and shared by every instance of a channel class in the
        process (the JAX package's aggregation scope)."""
        pv = getattr(self, "_acct_pv", None)
        if pv is None:
            from .. import mpit
            n = self.name
            pv = (mpit.pvar(f"chan_{n}_msgs_sent", mpit.PVAR_CLASS_COUNTER,
                            f"packets sent on the {n} channel"),
                  mpit.pvar(f"chan_{n}_bytes_sent", mpit.PVAR_CLASS_COUNTER,
                            f"payload bytes sent on the {n} channel"))
            self._acct_pv = pv
        return pv

    def account_send(self, dest_world: int, nbytes: int) -> None:
        pv = self._acct_pvars()
        pv[0].inc()
        pv[1].inc(nbytes)

    def send_packet(self, dest_world: int, pkt: Packet) -> None:
        raise NotImplementedError

    # -- zero-copy rendezvous hooks (RGET path) ---------------------------
    def expose_buffer(self, array: np.ndarray) -> Any:
        """Register a send buffer for remote pull; returns an opaque
        handle carried in the RTS."""
        raise NotImplementedError

    def pull_buffer(self, src_world: int, handle: Any,
                    nbytes: int) -> np.ndarray:
        """RGET: read the peer's exposed buffer."""
        raise NotImplementedError

    def release_buffer(self, handle: Any) -> None:
        pass
