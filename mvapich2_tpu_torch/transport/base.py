"""The channel interface under the point-to-point protocol (a trimmed
copy of the JAX package's ``transport/base.py``).

A channel moves opaque packets between world ranks; the protocol layer
above it (``pt2pt/protocol.py``) implements matching and the eager and
rendezvous state machines. Channels of the port:

* ``local`` (``transport/local.py``): the in-process fabric of thread
  ranks, which hands packets over by reference;
* ``tcp`` (``transport/tcp.py``): sockets between rank processes;
* ``shm`` (``transport/shm.py``): shared-memory rings between rank
  processes of one node.

The two process channels put a packet on the wire with the JAX
package's codec (``encode_packet`` / ``decode_packet``, byte for byte
the same blob), and the progress engine polls them
(``transport/progress.py``). The packet types of the tiers that wait
(the one-sided host windows, ULFM revoke) are not ported.
"""

from __future__ import annotations

import enum
import pickle as _pickle
import struct as _struct
from typing import Any, Dict, Optional

import numpy as np


class PktType(enum.IntEnum):
    """Packet types, with the JAX package's numbers."""

    EAGER_SEND = 1
    RNDV_RTS = 2           # request-to-send (no payload)
    RNDV_CTS = 3           # clear-to-send (receiver matched)
    RNDV_DATA = 4          # RPUT/R3 payload chunk
    RNDV_FIN = 5           # transfer complete
    RNDV_APUB = 6          # pipelined arena rendezvous: chunks published
    RNDV_AACK = 7          # pipelined arena rendezvous: chunks consumed
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


# ---------------------------------------------------------------------------
# binary wire codec (the JAX package's, byte for byte)
# ---------------------------------------------------------------------------
# Fixed struct header + optional pickled ``extra`` + raw payload:
#   _PKT_HDR | extra (exlen bytes, pickle protocol 5) | payload (the rest)
# ``protocol`` is an 8-byte NUL-padded field (RGET/RPUT/R3 fit).

_PKT_HDR = _struct.Struct("<Biiiiqqqq8si")
PKT_HDR_SIZE = _PKT_HDR.size

# bit 30 of ctx: the JAX package's native plane claims packets that carry
# it; decode_packet strips it, so a receiver without that plane matches
PLANE_CTX_FLAG = 1 << 30


def encode_packet(pkt: Packet) -> bytes:
    """Serialize to one contiguous blob (a single payload copy)."""
    ex = b"" if pkt.extra is None else _pickle.dumps(pkt.extra, 5)
    hdr = _PKT_HDR.pack(int(pkt.type), pkt.src_world, pkt.ctx,
                        pkt.comm_src, pkt.tag, pkt.nbytes, pkt.sreq_id,
                        pkt.rreq_id, pkt.offset,
                        pkt.protocol.encode("ascii"), len(ex))
    if pkt.data is None:
        return hdr + ex
    # b"".join takes buffer-protocol objects: the payload (an ndarray or
    # memoryview) is copied exactly once, into the blob
    return b"".join((hdr, ex, memoryview(pkt.data).cast("B")))


def decode_packet(blob) -> Packet:
    """Inverse of :func:`encode_packet`; ``blob`` is bytes or a
    memoryview. The payload is a uint8 view of ``blob``."""
    (ptype, src_world, ctx, comm_src, tag, nbytes, sreq_id, rreq_id,
     offset, proto, exlen) = _PKT_HDR.unpack_from(blob, 0)
    pos = PKT_HDR_SIZE
    extra = None
    if exlen:
        extra = _pickle.loads(bytes(blob[pos:pos + exlen]))
        pos += exlen
    data = None
    if len(blob) > pos:
        data = np.frombuffer(blob, dtype=np.uint8, offset=pos)
    return Packet(PktType(ptype), src_world, ctx & ~PLANE_CTX_FLAG,
                  comm_src, tag, nbytes, data, sreq_id, rreq_id,
                  proto.rstrip(b"\0").decode("ascii"), offset, extra)


class Channel:
    """The transport seam: one rank's end of a fabric. The in-process
    fabric pushes a delivery into the peer engine's inbox
    (``ProgressEngine.enqueue_incoming``) and has nothing to poll; a
    process channel is polled by its engine (``poll``) and names the
    files its engine's idle wait selects on (``wait_fds``)."""

    name = "abstract"
    # True if the engine must poll the channel (``poll``): a process
    # channel; the in-process fabric pushes into the engine's inbox
    polled = False
    # True if RTS packets may carry a zero-copy handle the receiver can
    # pull from directly (the RGET path)
    supports_rget = False

    def attach(self, engine) -> None:
        """Bind to the owning rank's progress engine."""
        self.engine = engine

    # -- traffic accounting (the JAX package's per-channel pvars) ---------
    def _acct_pvars(self):
        """The ``chan_<name>_{msgs,bytes}_{sent,recv}`` counters, declared
        on first use and shared by every instance of a channel class in
        the process (the JAX package's aggregation scope)."""
        pv = getattr(self, "_acct_pv", None)
        if pv is None:
            from .. import mpit
            n = self.name
            pv = (mpit.pvar(f"chan_{n}_msgs_sent", mpit.PVAR_CLASS_COUNTER,
                            f"packets sent on the {n} channel"),
                  mpit.pvar(f"chan_{n}_bytes_sent", mpit.PVAR_CLASS_COUNTER,
                            f"bytes sent on the {n} channel (wire bytes "
                            f"on a process channel, payload bytes on the "
                            f"in-process fabric)"),
                  mpit.pvar(f"chan_{n}_msgs_recv", mpit.PVAR_CLASS_COUNTER,
                            f"packets received on the {n} channel"),
                  mpit.pvar(f"chan_{n}_bytes_recv", mpit.PVAR_CLASS_COUNTER,
                            f"wire bytes received on the {n} channel"))
            self._acct_pv = pv
        return pv

    def account_send(self, dest_world: int, nbytes: int) -> None:
        pv = self._acct_pvars()
        pv[0].inc()
        pv[1].inc(nbytes)

    def account_recv(self, nbytes: int) -> None:
        pv = self._acct_pvars()
        pv[2].inc()
        pv[3].inc(nbytes)

    def send_packet(self, dest_world: int, pkt: Packet) -> None:
        raise NotImplementedError

    # -- the progress contract (process channels) -------------------------
    def poll(self) -> bool:
        """Advance I/O; True if a packet was moved. The in-process fabric
        pushes into the engine's inbox and has nothing to poll."""
        return False

    def wait_fds(self):
        """Files that turn readable when inbound traffic arrives; the
        engine's idle wait selects on the union over its channels."""
        return []

    def pre_wait(self) -> None:
        """Called before the engine's last empty poll ahead of an idle
        wait: a channel may advertise that its rank sleeps, so senders
        ring its doorbell (the shared-memory channel's adaptive bell).
        Advertise, then the final poll, then sleep: no send is missed."""

    def post_wait(self) -> None:
        """Called after the idle wait returns."""

    def close(self) -> None:
        pass

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
