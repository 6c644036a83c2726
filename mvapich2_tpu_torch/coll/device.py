"""The device-collective channels behind the MPI seam (counterpart of the
JAX package's ``coll/device.py``).

A device-bound ``Comm`` gets its ``coll_fns`` entries replaced by
wrappers that run the collective on the device. Ranks are threads of one
process (the ``run_ranks`` harness); a collective call is executed once:
every rank deposits its buffer at a rendezvous, rank 0 (the leader) runs
the device program, every rank picks up its result.

Two bindings are ported:

* :class:`DeviceCollChannel`, the 1:1 mesh channel: each rank owns one
  virtual device of a ``parallel.mesh.Mesh`` (``p`` virtual ranks of one
  card, or of the CPU in tests). The leader hands the ``p`` deposited
  shards in place to the tier dispatch of ``ops/ici.py`` (ring kernels
  K3/K5/K6/K7, or the stock torch reduction) and every rank gets its own
  output;
* :class:`HBMSlotChannel`: all ranks share one device and collectives
  run through an on-card slot segment (``ops/hbm.py``).

The per-chip fold channel, multi-axis meshes, nonblocking collectives and
the host algorithm tier are not ported; a call that would need the host
tier (an 8-byte dtype, a user-defined op, a forced host algorithm,
``USE_DEVICE_COLL`` off) raises ``NotImplementedError``, and so does
alltoall on the 1:1 channel (its kernel, K10, is not ported).

Stream order across rank threads (CUDA devices): each deposit records an
event on the depositing rank's current stream; the leader's stream waits
on all of them before it stages and launches, records one event after
the launch, and every rank's stream waits on that event before the
collective returns. The slot channel never synchronizes the host with
the device, except the device-to-host copy that fills a numpy
``recvbuf``; the 1:1 channel's leader waits on its stream after each
call, to read the ring kernels' error word.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import mpit
from ..core import op as opmod
from ..ops import hbm, ici, ring
from ..utils import is_device_tensor
from ..utils.config import get_config


def _op_name(op) -> Optional[str]:
    """Map a core.op builtin to a device reduction name (None = none)."""
    table = {id(opmod.SUM): "sum", id(opmod.MAX): "max",
             id(opmod.MIN): "min", id(opmod.PROD): "prod"}
    return table.get(id(op))


def _dtype_lowers(kind: str, itemsize: int) -> bool:
    """True when the dtype runs on the device: integer or float kinds of
    at most 4 bytes (the JAX package's rule with 64-bit types off)."""
    return kind in "fiu" and itemsize <= 4


def _dtype_kind(buf) -> Tuple[str, int]:
    """(numpy-style kind, itemsize) of a tensor's or array's dtype."""
    if isinstance(buf, torch.Tensor):
        return ici.dtype_kind(buf.dtype), buf.element_size()
    dt = np.dtype(buf.dtype)
    return dt.kind, dt.itemsize


class _Rendezvous:
    """Per-bound-comm meeting point: a slot per rank's deposit, two
    barrier phases per collective (deposit -> leader compute -> pickup).
    MPI requires every rank to issue collectives on a comm in the same
    order, so one in-flight collective per comm is the contract."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots: List = [None] * size
        self.events: List[Optional[torch.cuda.Event]] = [None] * size
        self.result: List = [None] * size
        self.done: Optional[torch.cuda.Event] = None
        self.error: Optional[BaseException] = None

    def abort(self) -> None:
        """Break the barrier so peers blocked in a device collective see
        a failure instead of deadlocking (called when a rank dies)."""
        self.barrier.abort()


def _record_event(device: torch.device) -> Optional[torch.cuda.Event]:
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Channel:
    """What both channels share: one rank's place at the rendezvous, the
    execution of a call (deposit, the leader runs the program, pickup),
    its per-call accounting, and the MPI-shaped entry points. A subclass
    gives ``LEVELS``, ``SUPPORTED``, ``_build``, ``_leader`` and
    ``_note_tier``."""

    # hierarchy levels one call on this channel exercises (the
    # coll_level_* pvars bumped per call in _run)
    LEVELS: Tuple[str, ...] = ()
    # collectives this channel routes to the device
    SUPPORTED: Tuple[str, ...] = ()

    def __init__(self, device: torch.device, rendezvous: _Rendezvous,
                 rank: int, size: int):
        self.device = torch.device(device)
        self.rv = rendezvous
        self.rank = rank
        self.size = size
        self._programs: Dict = {}

    def abort(self) -> None:
        self.rv.abort()

    def _program(self, name: str, n: int, dtype_str: str, op: str):
        """The leader's callable for one signature, built once."""
        key = (name, n, dtype_str, op)
        got = self._programs.get(key)
        if got is None:
            got = self._programs[key] = self._build(name, n, op)
        return got

    # -- the rendezvous execution ----------------------------------------
    @staticmethod
    def _slot_extent(slot) -> Tuple[int, str]:
        """(n, dtype string) of a deposited slot, without moving it."""
        if is_device_tensor(slot):
            return slot.numel(), str(slot.dtype)
        arr = np.asarray(slot)
        return int(arr.size), str(arr.dtype)

    def _execute(self, name: str, local, op: str = "sum", root: int = 0):
        """Run one device collective; ``local`` is this rank's flat
        contribution (numpy array or tensor). Deposit at the rendezvous,
        rank 0 runs ``_leader``, everyone picks up its result."""
        rv = self.rv
        rv.slots[self.rank] = local
        rv.events[self.rank] = _record_event(self.device)
        try:
            rv.barrier.wait()
        except threading.BrokenBarrierError:
            raise RuntimeError(
                "device collective aborted: a peer rank failed") from None
        if self.rank == 0:
            try:
                rv.result = self._leader(name, op, root)
                rv.done = _record_event(self.device)
                rv.error = None
            except BaseException as e:   # noqa: BLE001 - must release peers
                rv.error = e
                rv.result = [None] * self.size
                rv.done = None
        try:
            rv.barrier.wait()
        except threading.BrokenBarrierError:
            rv.slots[self.rank] = None
            raise RuntimeError(
                "device collective aborted: a peer rank failed") from None
        # release this rank's references promptly: retained slots and
        # results would pin device memory for the life of an idle comm
        res, rv.result[self.rank] = rv.result[self.rank], None
        rv.slots[self.rank] = None
        rv.events[self.rank] = None
        if rv.error is not None:
            raise RuntimeError(
                f"device collective {name} failed on the leader"
            ) from rv.error
        if rv.done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(rv.done)
            if isinstance(res, torch.Tensor):
                # the result was allocated on the leader's stream: keep
                # its memory from being reused while this stream reads it
                res.record_stream(stream)
        return res

    def _run(self, name: str, local, op: str = "sum", root: int = 0):
        """Per-call accounting around ``_execute``: the tier pvars, the
        coll_level_* counters and the dev_effbw_<tier> watermark. On a
        CUDA device the time is the host clock around the rendezvous and
        the enqueue."""
        tier = self._note_tier(name, local, op if name != "bcast" else None)
        for lv in self.LEVELS:
            mpit.pvar(f"coll_level_{lv}").inc()
        n = self._slot_extent(local)[0]
        nbytes = n * _torch_dtype(local).itemsize
        t0 = time.perf_counter()
        out = self._execute(name, local, op=op, root=root)
        dt = time.perf_counter() - t0
        if dt > 0 and nbytes > 0:
            mpit.pvar(f"dev_effbw_{tier}").mark(nbytes / dt / 1e9)
        return out

    # -- MPI-shaped entry points (match coll_fns signatures) -------------
    def allreduce(self, comm, sendbuf, recvbuf, count, datatype, op):
        local = _as_local(sendbuf, recvbuf, count)
        out = self._run("allreduce", local, op=_op_name(op))
        return _deliver(out, recvbuf)

    def reduce(self, comm, sendbuf, recvbuf, count, datatype, op, root):
        local = _as_local(sendbuf, recvbuf, count)
        out = self._run("reduce", local, op=_op_name(op), root=root)
        if comm.rank != root:
            return None
        return _deliver(out, recvbuf)

    def bcast(self, comm, buf, count, datatype, root):
        out = self._run("bcast", _as_local(buf, buf, count),
                        op=None, root=root)
        return _deliver(out, buf)

    def allgather(self, comm, sendbuf, recvbuf, count, datatype):
        local = _as_local(sendbuf, recvbuf, count,
                          in_place_start=comm.rank * count)
        out = self._run("allgather", local, op=None)
        return _deliver(out, recvbuf)

    def alltoall(self, comm, sendbuf, recvbuf, count, datatype):
        local = _as_local(sendbuf, recvbuf, count * comm.size)
        out = self._run("alltoall", local, op=None)
        return _deliver(out, recvbuf)

    def reduce_scatter_block(self, comm, sendbuf, recvbuf, count, datatype,
                             op):
        local = _as_local(sendbuf, recvbuf, count * comm.size)
        out = self._run("reduce_scatter_block", local,
                        op=_op_name(op))
        return _deliver(out, recvbuf)


class DeviceCollChannel(_Channel):
    """One rank's handle on the 1:1 mesh channel: rank r owns virtual
    device r of ``mesh``.

    The leader's programs (``_build``):

      * allreduce/reduce: ``ici.ici_all_reduce`` (K6 / K3 / stock, by
        tier), one output row per rank;
      * allgather: ``ici.ici_all_gather`` (K7 / K5 / stock);
      * bcast: a copy of the root's shard per rank (stock, as the JAX
        package lowers it through XLA);
      * reduce_scatter_block: the stock reduction over the stacked
        shards, then rank r's block.

    The leader waits for each call's device work and raises if a ring
    kernel's spin wait timed out, so every rank of that call raises.
    """

    LEVELS = ("ici",)
    # alltoall waits for its kernel, K10
    SUPPORTED = ("allreduce", "reduce", "bcast", "allgather",
                 "reduce_scatter_block")

    def __init__(self, mesh, rendezvous: _Rendezvous, rank: int):
        super().__init__(mesh.device, rendezvous, rank, mesh.size)
        self.mesh = mesh

    def _build(self, name: str, n: int, op: str):
        """The leader's program for one signature: a callable taking the
        ``p`` flat shards and the root, returning one output per rank.
        ``_note_tier`` counts the call's tier on every rank."""
        p = self.size
        if name in ("allreduce", "reduce"):
            def f(xs, root):
                return list(ici.ici_all_reduce(xs, op).unbind(0))
        elif name == "allgather":
            def f(xs, root):
                return list(ici.ici_all_gather(xs).unbind(0))
        elif name == "bcast":
            def f(xs, root):
                return list(xs[root].reshape(1, n).expand(p, n).clone()
                            .unbind(0))
        elif name == "reduce_scatter_block":
            c = n // p

            def f(xs, root):
                y = ici.stock_reduce(torch.stack(xs), op)
                return [y[r * c:(r + 1) * c] for r in range(p)]
        else:  # pragma: no cover
            raise KeyError(name)
        return f

    def _leader(self, name: str, op: str, root: int) -> List:
        """Leader compute: order this stream after every deposit, hand
        the ``p`` shards in place to the program (one output per rank),
        then wait for it and raise on a ring kernel's spin timeout."""
        rv = self.rv
        _wait_deposits(self.device, rv.events)
        n, dtype = self._slot_extent(rv.slots[0])
        xs = [_to_device(s, self.device).reshape(n) for s in rv.slots]
        out = self._program(name, n, dtype, op)(xs, root)
        ring.check_errors(self.device)
        return out

    def _note_tier(self, name: str, local, op: Optional[str]) -> str:
        """Count which tier THIS call runs (dev_coll_tier_{vmem,hbm}, or
        dev_coll_fallback_<reason> when the stock lowering is taken) and
        return its label ('vmem'/'hbm'/'xla'), keyed as the JAX
        package's: the tier ``planned_tier`` names for the call's shard
        bytes (output bytes for allgather)."""
        if name not in ("allreduce", "reduce", "allgather"):
            return "xla"    # collectives without a ring-kernel lowering
        n, _ = self._slot_extent(local)
        dtype = _torch_dtype(local)
        nbytes = n * dtype.itemsize * (self.size if name == "allgather"
                                       else 1)
        tier, reason = ici.planned_tier(name, nbytes, dtype, op)
        if reason is None:
            mpit.pvar(f"dev_coll_tier_{tier}").inc()
            return tier
        mpit.pvar(f"dev_coll_fallback_{reason}").inc()
        return "xla"


class HBMSlotChannel(_Channel):
    """All bound ranks share ONE device: collectives run through an
    on-card slot segment (``ops/hbm.py``). Every rank deposits at the
    rendezvous, the leader stages one planar ``(R, n)`` slot tensor and
    runs one program:

      * allreduce/reduce: one slot-reduce pass (K1) writing the result
        ONCE; the broadcast is zero-copy: every rank is handed the SAME
        result tensor, which is shared and must not be written in place;
      * allgather: the slot tensor *is* the result (no device compute);
      * alltoall: one transpose of the slot tensor;
      * reduce_scatter_block: slot-reduce (K1), then per-rank slices;
      * bcast: a copy of the root slot, shared by all ranks.

    ``sum`` runs K1 (on a CUDA device it launches the kernel or raises);
    ``max``/``min``/``prod`` take the stock torch reduction, as the JAX
    channel takes XLA's for them.
    """

    LEVELS = ("chip",)
    SUPPORTED = ("allreduce", "reduce", "bcast", "allgather", "alltoall",
                 "reduce_scatter_block")

    def _note_tier(self, name: str, local, op: Optional[str]) -> str:
        return "slot"       # single-device slot channel: no ring tiers

    def _build(self, name: str, n: int, op: str):
        R = self.size
        if name in ("allreduce", "reduce", "reduce_scatter_block"):
            if op == "sum":
                return hbm.hbm_slot_allreduce
            red = {"max": torch.amax, "min": torch.amin,
                   "prod": torch.prod}[op]

            def f(x):
                return red(x, 0).to(x.dtype)
        elif name == "bcast":
            def f(x):                       # staged root slot [n]
                return x
        elif name == "allgather":
            def f(x):                       # [R, n] -> [R*n], zero compute
                return x.reshape(R * n)
        elif name == "alltoall":
            c = n // R

            def f(x):                       # [R, n] -> [R, R, c] transpose
                return x.reshape(R, R, c).permute(1, 0, 2).contiguous()
        else:  # pragma: no cover
            raise KeyError(name)
        return f

    def _leader(self, name: str, op: str, root: int) -> List:
        """Leader compute: order this stream after every deposit, stage
        the planar slot tensor on the device, run the program, share or
        scatter the result."""
        rv = self.rv
        R = self.size
        _wait_deposits(self.device, rv.events)
        n, dtype = self._slot_extent(rv.slots[root])
        if name == "bcast":
            # a copy: the shared result must not alias the root's buffer
            x = _to_device(rv.slots[root], self.device).reshape(n).clone()
        elif all(is_device_tensor(s) for s in rv.slots):
            x = torch.stack([_to_device(s, self.device).reshape(n)
                             for s in rv.slots])
        else:
            # host slots: one host-side stack, one transfer
            x = _to_device(np.stack([np.asarray(s).reshape(n)
                                     for s in rv.slots]), self.device)
        out = self._program(name, n, dtype, op)(x)
        if name == "alltoall":
            return [out[r] for r in range(R)]
        if name == "reduce_scatter_block":
            c = n // R
            return [out[r * c:(r + 1) * c] for r in range(R)]
        # the zero-copy share: every rank gets the same tensor
        return [out] * R


def _wait_deposits(device: torch.device, events) -> None:
    """Order the leader's stream after every rank's deposit."""
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        for ev in events:
            if ev is not None:
                stream.wait_event(ev)


def _torch_dtype(buf) -> torch.dtype:
    if is_device_tensor(buf):
        return buf.dtype
    return torch.from_numpy(np.empty(0, np.asarray(buf).dtype)).dtype


def _to_device(buf, device: torch.device) -> torch.Tensor:
    if is_device_tensor(buf):
        return buf if buf.device == device else buf.to(device)
    return torch.from_numpy(np.ascontiguousarray(buf)).to(device)


def _is_in_place(buf) -> bool:
    return type(buf).__name__ == "_InPlace"


def _as_local(sendbuf, recvbuf, count: int, in_place_start: int = 0):
    """This rank's contribution as a flat [count] tensor or array.
    MPI_IN_PLACE reads from recvbuf; ``in_place_start`` selects the
    rank's chunk (allgather-style in-place semantics)."""
    buf = sendbuf
    start = 0
    if _is_in_place(sendbuf):
        buf = recvbuf
        start = in_place_start
    if is_device_tensor(buf):
        return buf.reshape(-1)[start:start + count]
    return np.ascontiguousarray(
        np.asarray(buf).reshape(-1)[start:start + count])


def _deliver(out, recvbuf):
    """Copy the device result into a numpy recvbuf (device-to-host), or
    hand the flat result tensor back (tensor or absent recvbuf, or
    in-place: the comm methods return it to the caller)."""
    if recvbuf is None or is_device_tensor(recvbuf) or _is_in_place(recvbuf):
        return out if out.dim() == 1 else out.reshape(-1)
    host = out.reshape(-1).cpu().numpy()
    dst = np.asarray(recvbuf)
    if dst.size == host.size:
        # copyto writes through views, including non-contiguous ones
        np.copyto(dst, host.reshape(dst.shape))
    else:
        if not dst.flags.c_contiguous:
            raise ValueError(
                "device collective: non-contiguous recvbuf larger than "
                "the result is not supported")
        dst.reshape(-1)[:host.size] = host
    return None


# ---------------------------------------------------------------------------
# per-comm install
# ---------------------------------------------------------------------------

# wrapper name -> cvar prefix (reduce_scatter_block shares the
# REDUCE_SCATTER override, matching the MPI-level collective family)
_CVAR_OF = {"allreduce": "ALLREDUCE", "bcast": "BCAST",
            "allgather": "ALLGATHER", "alltoall": "ALLTOALL",
            "reduce": "REDUCE", "reduce_scatter_block": "REDUCE_SCATTER"}

_HOST_TIER = "the host collective tier is not ported"


def _select_transport(name: str, op, buf) -> str:
    """The transport for this call: 'device', or NotImplementedError
    where the JAX package would take its host tier. The decision must be
    identical on every rank of a call; its inputs (op, dtype, cvars) are
    required-uniform by MPI."""
    cfg = get_config()
    forced = cfg.get(f"{_CVAR_OF[name]}_ALGO", "")
    if forced and forced != "device":
        raise NotImplementedError(
            f"{name}: host algorithm {forced!r} forced; {_HOST_TIER}")
    if not cfg["USE_DEVICE_COLL"]:
        raise NotImplementedError(
            f"{name}: USE_DEVICE_COLL is off; {_HOST_TIER}")
    if op is not None and _op_name(op) is None:
        raise NotImplementedError(
            f"{name}: op {op!r} has no device reduction; {_HOST_TIER}")
    if not _dtype_ok(buf):
        raise NotImplementedError(
            f"{name}: dtype {getattr(buf, 'dtype', type(buf).__name__)} "
            f"does not run on the device (8-byte, bool and complex types "
            f"need the host tier); {_HOST_TIER}")
    return "device"


def _dtype_ok(buf) -> bool:
    if not hasattr(buf, "dtype"):
        return False
    return _dtype_lowers(*_dtype_kind(buf))


# position of the op argument in each entry's args (after the comm)
_OP_POS = {"allreduce": 4, "reduce": 4, "reduce_scatter_block": 4,
           "bcast": None, "allgather": None, "alltoall": None}


def install_device_coll(comm, channel: _Channel) -> None:
    """Point the device-capable entries of ``comm.coll_fns`` at the
    channel, behind the transport check."""
    comm.device_channel = channel

    def wrap(name):
        devfn = getattr(channel, name)
        op_pos = _OP_POS[name]

        def entry(comm_, *a):
            buf = a[0]
            if _is_in_place(buf) and len(a) > 1:
                buf = a[1]   # selection looks at the effective buffer
            op = a[op_pos] if op_pos is not None else None
            _select_transport(name, op, buf)
            return devfn(comm_, *a)
        return entry

    for name in channel.SUPPORTED:
        comm.coll_fns[name] = wrap(name)


# ---------------------------------------------------------------------------
# binding (harness entry point)
# ---------------------------------------------------------------------------

def bind_universes(universes, device: torch.device, mesh=None) -> bool:
    """Bind each thread-rank universe's COMM_WORLD. Geometry selects the
    channel, as in the JAX package:

      * a mesh of as many ranks as universes -> DeviceCollChannel (1:1);
      * a one-rank mesh under several ranks, or no mesh ->
        HBMSlotChannel on ``device`` (all ranks share it; with no mesh
        this holds for one rank too).

    A mesh of another size raises: the fold channel (1 < mesh < ranks)
    and the host path are not ported."""
    n = len(universes)
    one_to_one = mesh is not None and mesh.size == n
    if mesh is not None and not one_to_one:
        if mesh.size != 1:
            raise NotImplementedError(
                f"a mesh of {mesh.size} ranks cannot bind {n} ranks one "
                f"to one; the leaders-per-chip fold channel and the host "
                f"path are not ported")
        device = mesh.device
    rv = _Rendezvous(n)
    for r, u in enumerate(universes):
        ch = (DeviceCollChannel(mesh, rv, r) if one_to_one
              else HBMSlotChannel(device, rv, r, n))
        install_device_coll(u.comm_world, ch)
    return True
