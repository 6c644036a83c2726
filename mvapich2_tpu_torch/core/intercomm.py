"""Intercommunicators (a trimmed copy of the JAX package's
``core/intercomm.py``, MPI-3.1 §6.6).

Two disjoint groups bridged by a leader pair. The context id is agreed
across both sides (``bridge_agree``: each side's allreduce-max of its
next free id, exchanged between the leaders), so matching works with one
shared id although the sides allocate ids independently. ``rank`` and
``size`` describe the local group; point-to-point ranks and collective
roots name ranks of the remote group (``world_of``, ``_check_rank``);
the root of a rooted collective is ``ROOT`` on its origin,
``PROC_NULL`` on the other ranks of the origin side and the origin's
rank on the receiving side. The collectives are the intercomm
algorithms of ``coll/inter.py`` (``_coll``) and the schedules of
``coll/nbc/inter.py`` (``coll/nonblocking.py`` ``_inter_fn``), on
numpy buffers.

An intercomm never binds a device channel, as in the JAX package: a
tensor on the card in one of its calls raises ``NotImplementedError``
naming the intercomm (``unbound_why``) and is never moved to the host; a
CPU tensor is read and written in place as numpy. ``merge`` gives an
intracomm that derives its channel as a ``dup`` does
(``coll/device.py`` ``bind_derived``): none when it holds spawned ranks.
The JAX package's C-plane ownership (``_plane_members``,
``_plane_bind``) is not ported.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from . import op as opmod
from .comm import Comm, _numel, _resolve
from .datatype import Datatype
from .errors import (MPI_ERR_COMM, MPI_ERR_COUNT, MPI_ERR_OTHER,
                     MPI_ERR_RANK, MPI_ERR_ROOT, MPIException, mpi_assert)
from .group import Group
from .status import ANY_SOURCE, PROC_NULL, ROOT, UNDEFINED


def _json_to_arr(obj) -> np.ndarray:
    """One encoding for every bridge header."""
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8).copy()


def _arr_to_json(arr: np.ndarray):
    return json.loads(arr.tobytes().decode())


def bcast_json(comm: Comm, obj, root: int):
    """Broadcast a JSON-serializable object over ``comm`` (length
    first)."""
    if comm.rank == root:
        payload = _json_to_arr(obj)
        comm.bcast(np.array([payload.size], dtype=np.int64), root=root)
        comm.bcast(payload, root=root)
        return obj
    n = np.zeros(1, dtype=np.int64)
    comm.bcast(n, root=root)
    payload = np.empty(int(n[0]), dtype=np.uint8)
    comm.bcast(payload, root=root)
    return _arr_to_json(payload)


def bridge_agree(local_comm: Comm, leader: int, exchange) -> dict:
    """The context-id agreement of every two-sided constructor
    (intercomm_create, merge, dup, split, create, connect, accept,
    spawn): an allreduce-max of the side's next free id, the leader's
    bridge (``exchange(lmax) -> dict`` with at least ``ctx``, run on the
    leader only, folding in the other side's max), a local bcast of the
    leader's dict and a reservation past the agreed id. Any failure on
    the leader reaches every rank of the side as an MPIException of its
    class, instead of leaving them blocked in the bcast."""
    u = local_comm.u
    mine = np.array([u._next_ctx], dtype=np.int64)
    lmax = np.zeros_like(mine)
    local_comm.allreduce(mine, lmax, op=opmod.MAX)
    hdr = None
    if local_comm.rank == leader:
        try:
            hdr = exchange(int(lmax[0]))
        except Exception as e:   # noqa: BLE001 - re-raised on every rank
            hdr = {"ctx": int(lmax[0]),
                   "error": f"{type(e).__name__}: {e}",
                   "eclass": getattr(e, "error_class", MPI_ERR_OTHER)}
    hdr = bcast_json(local_comm, hdr, leader)
    u._next_ctx = max(u._next_ctx, int(hdr["ctx"]) + 2)
    if hdr.get("error"):
        raise MPIException(hdr.get("eclass", MPI_ERR_OTHER), hdr["error"])
    return hdr


def _xchg_i64(comm: Comm, peer: int, tag: int,
              arr: np.ndarray) -> np.ndarray:
    """Leader bridge: exchange variable-length int64 arrays with
    ``peer`` over ``comm`` (a probe learns the incoming length)."""
    sreq = comm.isend(arr, peer, tag)
    st = comm.probe(peer, tag)
    out = np.empty(st.count // 8, dtype=np.int64)
    comm.recv(out, peer, tag)
    sreq.wait()
    return out


def _xchg_json(comm: Comm, peer: int, tag: int, obj: dict) -> dict:
    """Leader bridge: exchange JSON headers (member lists and their node
    names) with ``peer``."""
    sreq = comm.isend(_json_to_arr(obj), peer, tag)
    st = comm.probe(peer, tag)
    out = np.empty(st.count, dtype=np.uint8)
    comm.recv(out, peer, tag)
    sreq.wait()
    return _arr_to_json(out)


class Intercomm(Comm):
    is_inter = True

    def __init__(self, universe, local_group: Group, remote_group: Group,
                 context_id: int, local_comm: Comm, name: str = ""):
        super().__init__(universe, local_group, context_id, name)
        self.remote_group = remote_group
        self.local_comm = local_comm   # private intracomm over the local group
        self.unbound_why = ("an intercommunicator runs the host algorithms "
                            "of coll/inter.py")

    # -- rank resolution: point-to-point and roots name the remote group --
    @property
    def remote_size(self) -> int:
        return self.remote_group.size

    def world_of(self, rank: int) -> int:
        if rank in (PROC_NULL, ANY_SOURCE):
            return rank
        return self.remote_group.world_of_rank(rank)

    def _check_rank(self, r: int, allow_any: bool = False) -> None:
        if r == PROC_NULL or (allow_any and r == ANY_SOURCE):
            return
        mpi_assert(0 <= r < self.remote_size, MPI_ERR_RANK,
                   f"rank {r} invalid for remote group of size "
                   f"{self.remote_size}")

    def _check_root(self, root: int) -> None:
        if root not in (ROOT, PROC_NULL) and \
                not 0 <= root < self.remote_size:
            raise MPIException(MPI_ERR_ROOT, f"bad root {root} for an "
                               f"intercommunicator whose remote group has "
                               f"{self.remote_size} ranks")

    # -- collectives: the intercomm algorithm set -------------------------
    def _coll(self, name: str):
        from ..coll import inter
        fn = inter.COLL_FNS.get(name)
        if fn is None:
            raise MPIException(MPI_ERR_COMM, f"collective '{name}' not "
                               f"defined on intercommunicators")
        return inter.on_host(name, fn)

    # the root-aware (ROOT allocates) and remote-sized entries
    def reduce(self, sendbuf, recvbuf=None, op=None, root: int = 0,
               count: Optional[int] = None,
               datatype: Optional[Datatype] = None):
        self._check()
        self._check_root(root)
        op = op or opmod.SUM
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None and root == ROOT:
            recvbuf = np.empty_like(np.asarray(sendbuf))
        self._coll("reduce")(self, sendbuf, recvbuf, count, datatype, op,
                             root)
        return recvbuf

    def allgather(self, sendbuf, recvbuf=None, count: Optional[int] = None,
                  datatype: Optional[Datatype] = None):
        self._check()
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None:
            recvbuf = np.empty((self.remote_size * count,),
                               dtype=np.asarray(sendbuf).dtype)
        self._coll("allgather")(self, sendbuf, recvbuf, count, datatype)
        return recvbuf

    def gather(self, sendbuf, recvbuf=None, root: int = 0,
               count: Optional[int] = None,
               datatype: Optional[Datatype] = None):
        self._check()
        count, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None and root == ROOT:
            sb = np.frombuffer(sendbuf, dtype=np.uint8) \
                if isinstance(sendbuf, (bytes, bytearray)) \
                else np.asarray(sendbuf)
            recvbuf = np.empty((self.remote_size * count,), dtype=sb.dtype)
        self._coll("gather")(self, sendbuf, recvbuf, count, datatype, root)
        return recvbuf

    def alltoall(self, sendbuf, recvbuf=None, count: Optional[int] = None,
                 datatype: Optional[Datatype] = None):
        self._check()
        if count is None:
            count = _numel(sendbuf) // self.remote_size
        _, datatype = _resolve(sendbuf, count, datatype, alt=recvbuf)
        sendbuf, recvbuf = self._stage_if_unbound(sendbuf, recvbuf)
        if recvbuf is None:
            recvbuf = np.empty_like(np.asarray(sendbuf))
        self._coll("alltoall")(self, sendbuf, recvbuf, count, datatype)
        return recvbuf

    def alltoallv(self, sendbuf, sendcounts, sdispls, recvbuf, recvcounts,
                  rdispls, datatype: Optional[Datatype] = None):
        """Counts and displacements address the remote group."""
        self._check()
        _, datatype = _resolve(sendbuf, None, datatype, alt=recvbuf)
        if len(sendcounts) != self.remote_size \
                or len(recvcounts) != self.remote_size:
            raise MPIException(MPI_ERR_COUNT, f"alltoallv needs "
                               f"{self.remote_size} send and receive counts")
        self._coll("alltoallv")(
            self, sendbuf, [int(c) for c in sendcounts],
            list(sdispls) if sdispls is not None else None, recvbuf,
            [int(c) for c in recvcounts],
            list(rdispls) if rdispls is not None else None, datatype)
        return recvbuf

    # -- the context id across both sides ---------------------------------
    def _agree_ctx(self) -> int:
        """Collective over the intercomm: a context id fresh on both
        sides (bridge_agree with a leader sendrecv on the collective
        context)."""
        tag = self.next_coll_tag()
        from ..coll.algorithms import csendrecv

        def exchange(lmax: int) -> dict:
            other = np.zeros(1, dtype=np.int64)
            csendrecv(self, np.array([lmax], dtype=np.int64), 0, other, 0,
                      tag)
            return {"ctx": max(lmax, int(other[0]))}

        return int(bridge_agree(self.local_comm, 0, exchange)["ctx"])

    def dup(self) -> "Intercomm":
        self._check()
        ctx = self._agree_ctx()
        new = Intercomm(self.u, self.group, self.remote_group, ctx,
                        self.local_comm.dup(), self.name + "_dup")
        self.attrs.copy_all(self, new.attrs)
        return new

    def split(self, color, key: int = 0) -> Optional["Intercomm"]:
        """MPI_Comm_split on an intercomm (MPI-3.1 §6.4.2): each local
        group splits, and equal colors pair across the sides. A rank of
        a color with no member on the other side, or of UNDEFINED, gets
        None. The colors share the agreed id pair: their member sets are
        disjoint, so their matching never meets."""
        self._check()
        tag = self.next_coll_tag()
        lc = self.local_comm
        mycolor = UNDEFINED if color is None else int(color)
        mine = np.array([mycolor, key, self.u.world_rank], dtype=np.int64)
        table = np.empty(3 * lc.size, dtype=np.int64)
        lc.allgather(mine, table, count=3)

        def exchange(lmax: int) -> dict:
            msg = np.concatenate([np.array([lmax], np.int64), table])
            other = _xchg_i64(self, 0, tag, msg)
            return {"ctx": max(lmax, int(other[0])),
                    "rtable": [int(x) for x in other[1:]]}

        hdr = bridge_agree(lc, 0, exchange)
        ctx, rtable = int(hdr["ctx"]), hdr["rtable"]
        local_ctx = ctx + 2     # the new intercomm's private local comm
        self.u._next_ctx = max(self.u._next_ctx, ctx + 4)
        if mycolor == UNDEFINED:
            return None

        def members(tab):
            sel = []
            for i in range(len(tab) // 3):
                c, k, wr = tab[3 * i], tab[3 * i + 1], tab[3 * i + 2]
                if int(c) == mycolor:
                    sel.append((int(k), i, int(wr)))
            sel.sort()
            return [wr for _, _, wr in sel]

        lg = Group(members([int(x) for x in table]))
        remm = members(rtable)
        new_local = Comm(self.u, lg, local_ctx, self.name + "_split_local")
        if not remm:
            new_local.free()
            return None
        return Intercomm(self.u, lg, Group(remm), ctx, new_local,
                         self.name + "_split")

    def create(self, group: Group) -> Optional["Intercomm"]:
        """MPI_Comm_create on an intercomm (MPI-3.1 §6.4.2): each side
        passes its local subgroup, and the result pairs the two.
        Non-members get None."""
        self._check()
        tag = self.next_coll_tag()
        lc = self.local_comm

        def exchange(lmax: int) -> dict:
            msg = np.concatenate([np.array([lmax], np.int64),
                                  np.array(group.world_ranks, np.int64)])
            other = _xchg_i64(self, 0, tag, msg)
            return {"ctx": max(lmax, int(other[0])),
                    "remote": [int(x) for x in other[1:]]}

        hdr = bridge_agree(lc, 0, exchange)
        ctx, remm = int(hdr["ctx"]), hdr["remote"]
        self.u._next_ctx = max(self.u._next_ctx, ctx + 4)
        if self.u.world_rank not in group.world_ranks:
            return None
        new_local = Comm(self.u, group, ctx + 2,
                         self.name + "_create_local")
        if not remm:
            new_local.free()
            return None
        return Intercomm(self.u, group, Group(remm), ctx, new_local,
                         self.name + "_create")

    def merge(self, high: bool = False) -> Comm:
        """MPI_Intercomm_merge: the union intracomm, the low group's
        ranks first (equal ``high`` flags: the side with the smaller
        least world id is low, which both sides compute alike). Its
        device channel derives as a dup's does: none when spawned ranks
        are members (``coll/device.py`` ``bind_derived``)."""
        self._check()
        tag = self.next_coll_tag()
        lc = self.local_comm
        hs = np.array([int(high)], dtype=np.int64)
        hmin, hmax = np.zeros(1, np.int64), np.zeros(1, np.int64)
        lc.allreduce(hs, hmin, op=opmod.MIN)
        lc.allreduce(hs, hmax, op=opmod.MAX)
        if int(hmin[0]) != int(hmax[0]):
            raise MPIException(MPI_ERR_COMM,
                               "inconsistent high flags in Intercomm_merge")
        from ..coll.algorithms import csendrecv

        def exchange(lmax: int) -> dict:
            other = np.zeros(2, dtype=np.int64)
            csendrecv(self, np.array([lmax, int(high)], dtype=np.int64), 0,
                      other, 0, tag)
            return {"ctx": max(lmax, int(other[0])), "rh": int(other[1])}

        hdr = bridge_agree(lc, 0, exchange)
        remote_high = bool(hdr["rh"])
        local_ranks = list(self.group.world_ranks)
        remote_ranks = list(self.remote_group.world_ranks)
        if high == remote_high:
            i_am_low = min(local_ranks) < min(remote_ranks)
        else:
            i_am_low = not high
        order = (local_ranks + remote_ranks) if i_am_low \
            else (remote_ranks + local_ranks)
        return self._derive(Comm(self.u, Group(order), int(hdr["ctx"]),
                                 self.name + "_merged"))

    def disconnect(self) -> None:
        """MPI_Comm_disconnect: a collective quiesce, then free."""
        self.barrier()
        self.free()

    def free(self) -> None:
        if not self.freed and self.local_comm is not None:
            self.local_comm.free()
        super().free()

    def __repr__(self):
        return (f"Intercomm({self.name or 'anon'}, rank={self.rank}/"
                f"{self.size}|remote {self.remote_size}, "
                f"ctx={self.context_id})")


def intercomm_create(local_comm: Comm, local_leader: int,
                     peer_comm: Comm, remote_leader: int,
                     tag: int = 0) -> Intercomm:
    """MPI_Intercomm_create: collective over both local groups; the
    leaders talk over ``peer_comm``. They exchange the agreed-max id,
    their group's world ids and those procs' node names (the other side
    may never have met them: a spawn from COMM_SELF leaves the other
    ranks blind), broadcast them to their sides, and every rank builds
    the intercomm."""
    u = local_comm.u
    private = local_comm.dup()

    def exchange(lmax: int) -> dict:
        members = [int(w) for w in private.group.world_ranks]
        other = _xchg_json(peer_comm, remote_leader, tag,
                           {"max": lmax, "members": members,
                            "nodes": [u.node_name_of(w) for w in members]})
        return {"ctx": max(lmax, int(other["max"])),
                "remote": [int(x) for x in other["members"]],
                "rnodes": list(other["nodes"])}

    hdr = bridge_agree(private, local_leader, exchange)
    remote_ranks = hdr["remote"]
    if u.world_rank in remote_ranks:
        raise MPIException(MPI_ERR_COMM, "intercomm_create groups overlap")
    u.learn_procs(zip(remote_ranks, hdr.get("rnodes", [])))
    return Intercomm(u, private.group, Group(remote_ranks), int(hdr["ctx"]),
                     private, name="intercomm")
