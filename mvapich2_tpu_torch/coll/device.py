"""The device-collective channels behind the MPI seam (counterpart of the
JAX package's ``coll/device.py``).

A device-bound ``Comm`` gets its ``coll_fns`` entries replaced by
wrappers that run the collective on the device. Ranks are threads of one
process (the ``run_ranks`` harness); a collective call is executed once:
every rank deposits its buffer at a rendezvous, rank 0 (the leader) runs
the device program, every rank picks up its result.

Three bindings are ported, chosen by geometry (``bind_universes``, and
``bind_derived`` for the comms made from a bound one):

* :class:`DeviceCollChannel`, the 1:1 mesh channel: each rank owns one
  virtual device of a ``parallel.mesh.Mesh`` (``p`` virtual ranks of one
  card, or of the CPU in tests). The leader hands the ``p`` deposited
  shards in place to the tier dispatch of ``ops/ici.py`` (ring kernels
  K3/K5/K6/K7, the quantized ring K9 of ``ops/quant.py``, or the stock
  torch reduction) or of ``ops/alltoall.py`` (alltoall and alltoallv,
  K10/K11) and every rank gets its own output. On a mesh of two or more
  axes the reductions and the allgather run the per-axis ring phases
  of ``ops/ici.py`` ``ici_*_mesh`` (K4, K5, K3), and alltoall(v) the
  stock lowering over the flattened axes;
* :class:`DeviceFoldChannel`, leaders per chip: more ranks than mesh
  devices (``k`` ranks a device). Each device's ``k`` deposits fold in
  its memory (K1 for sum, the stock reduction otherwise), then the
  1:1 mesh program runs over the folded device shards, and the ranks of
  a device share its output; a tensor's alltoall(v) runs K10/K11 over
  every rank's deposit, flat;
* :class:`HBMSlotChannel`: all ranks share one device and collectives
  run through an on-card slot segment (``ops/hbm.py``); a tensor's
  alltoallv runs K11 over the deposits.

A call that the JAX package's ``_select_transport`` sends to the host
tier (an 8-byte, bool or complex dtype, a numpy bfloat16 array or a
user-defined op, also under a forced ``<COLL>_ALGO=device``; a forced
host algorithm; ``USE_DEVICE_COLL`` off without ``<COLL>_ALGO=device``;
a numpy buffer below ``DEVICE_COLL_MIN_BYTES``; alltoallv with
``MPI_IN_PLACE``; a numpy alltoallv on the slot channel and a numpy
alltoall(v) on the fold channel) runs the host entry the wrapper
replaced (``coll/api.py``, over the point-to-point protocol) on numpy
buffers and CPU tensors. A tensor on the card that such a call is given
raises ``NotImplementedError`` naming why the device tier refused it
(``_refuse_card``): no call moves a tensor from the card to the host
and back. Where the JAX package stages a device array through its host
tier but the port's kernels take the call, a tensor takes the device
(``TENSOR_ONLY``, and bfloat16: the kernels have bf16 cases, and
``ops/ici.py`` ``kernel_dtype`` plans it as an exact 2-byte type where
the JAX planners answer the stock lowering for ml_dtypes' kind 'V'). A
mesh that neither covers the ranks one to one nor divides them binds no
channel at all. The host tier is a
routing decision, never a fallback after a device failure: a kernel that
does not build or launch raises out of the collective.

Comms made by dup, create, split and split_type_shared of a bound run
(``bind_derived``) get a channel by the same geometry rule, applied to
their members' virtual devices in the new comm's rank order: one device,
the slot channel over its ``k`` ranks; ``k`` devices, the 1:1 channel
over a 1-D mesh of ``k`` (the run's own mesh when the members are its
devices in order); ``d`` devices holding equal contiguous runs, the fold
channel; anything else, none. Such a ``derived`` channel runs tensors
only: a numpy call takes the host tier with the JAX package's bits and
``coll_*`` pvars, as the JAX package's unbound comm takes it (the host
algorithms' own sub-comms, ``build_2level``, stay as they were). Its
rendezvous lives in the registry of the run's root rendezvous, keyed by
the context id and the sorted world ranks; the root's ``abort`` breaks
every derived one.

Nonblocking collectives (the JAX package's device NBC tier): on every
channel iallreduce, ibcast, iallgather, ialltoall and ialltoallv (and
their persistent ``*_init`` twins, ``core/comm.py``) become a small
schedule DAG (``coll/nbc``) of this rank: one CALL deposits the rank's
buffer into a per-sequence call record of the rendezvous and returns,
one POLL a segment launches the segment once every rank has deposited
(whichever rank polls first) and then reads its completion, and a last
CALL lands this rank's result in its ``recvbuf`` (``_Channel.nonblocking``
and ``_nb_*``). allreduce and bcast split into at most
``DEVICE_NBC_MAX_SEGS`` segments of ``DEVICE_NBC_SEG_BYTES`` a shard;
each segment runs the blocking path's program (``_compute``: the same
kernels; on the fold channel the chip fold, K1, then the ring, both on
the segment's slice) on a slice of the staged shards, enqueued on the
rendezvous's side stream behind every deposit's event, and one CUDA
event after it is what the poll queries: no poll and no launch waits for
the card. The result lands in a numpy ``recvbuf`` (device-to-host) or,
under a tensor ``sendbuf``, in a contiguous tensor one. On the slot and
fold channels a numpy ``sendbuf`` keeps the JAX route (``NB_NUMPY``). A
call the device tier cannot take (such a numpy call, ``MPI_IN_PLACE``,
a missing ``recvbuf``, a tensor ``recvbuf`` under a numpy ``sendbuf``, a
dtype or op that does not lower, a call ``_select_transport`` keeps on
the host) counts ``dev_coll_fallback_nbc`` and runs on the host schedule
(``coll/nonblocking.py``), as in the JAX package; given a tensor on the
card, it raises instead. A bfloat16 tensor i-call follows the blocking
rule: it rides the tier, landing in an ml_dtypes bfloat16 ``recvbuf``.

Observability (the JAX package's ``_run`` and ``_note_tier`` hooks): under
MV2T_TRACE each call drops a ``device``-lane ``dev_<coll>`` B/E span in
its rank's recorder (``tier``, ``op`` and ``bytes`` on B; ``tier`` and
``us``, the host-clock time of the rendezvous and the enqueue, on E),
with an NVTX range of the same name beside it on a CUDA device, and a
call that takes the stock lowering a ``channel``-lane
``dev_coll_fallback`` instant. A channel runs the first call of each
program it builds with its leader's recorder in ``trace.LOWERING``, so
the tier instants of ``ops/`` fire once a signature, as the JAX package
records them while it traces one. Every call records its time in the
``lat_dev_<tier>`` histogram (``metrics.LIVE``). MV2T_JAX_PROFILE=<dir>
runs a ``torch.profiler`` trace (CPU and CUDA activities) from the first
binding of ranks to a channel to the process's exit, written to <dir>
as a Chrome trace.

Stream order across rank threads (CUDA devices): each deposit records an
event on the depositing rank's current stream; the leader's stream waits
on all of them before it reads the deposits (in place, or staged) and
launches, records one event after the launch, and every rank's stream
waits on that event before the collective returns. The slot channel
never synchronizes the host with the device, except the device-to-host
copy that fills a numpy ``recvbuf``; the 1:1 channel's leader waits on
its stream after each call, to read the ring kernels' error word.
"""

from __future__ import annotations

import atexit
import contextlib
import logging
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import metrics, mpit, trace
from ..core import datatype as dtmod
from ..core import op as opmod
from ..core.comm import from_host, to_host
from ..core.errors import MPIX_ERR_PROC_FAILED, MPIException
from ..ops import alltoall, hbm, ici, quant, ring
from ..transport.progress import Doorbell
from ..utils import is_device_tensor, on_card
from ..utils.config import get_config

log = logging.getLogger("mvapich2_tpu_torch.coll.device")


# -- MV2T_JAX_PROFILE: the torch.profiler bracket ------------------------
# When the cvar names a directory, binding ranks to a device channel starts
# one torch.profiler trace (the JAX package starts jax.profiler at its
# first device collective; torch.profiler is stopped by the thread that
# started it, so the port starts it in the binding caller's thread) and
# an atexit hook stops it and writes the Chrome trace there.
_profiler = None
_profile_dir = ""
_profile_lock = threading.Lock()


def _start_profile(out_dir: str) -> None:
    global _profiler, _profile_dir
    with _profile_lock:
        if _profiler is not None:
            return
        from torch import profiler
        acts = [profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(profiler.ProfilerActivity.CUDA)
        try:    # the rank threads' host ops too, where torch offers it
            extra = {"experimental_config": profiler._ExperimentalConfig(
                profile_all_threads=True)}
        except (AttributeError, TypeError):
            extra = {}
        try:
            prof = profiler.profile(activities=acts, **extra)
            prof.start()
        except Exception as e:   # profiling must never stop a collective
            warnings.warn(f"MV2T_JAX_PROFILE: torch.profiler did not start "
                          f"({e!r})")
            return
        _profiler, _profile_dir = prof, out_dir
        atexit.unregister(_stop_profile)
        atexit.register(_stop_profile)


def _stop_profile() -> Optional[str]:
    """Stop the bracket and write its Chrome trace; returns the path (None
    when no bracket runs)."""
    global _profiler
    with _profile_lock:
        prof, _profiler = _profiler, None
    if prof is None:
        return None
    prof.stop()
    os.makedirs(_profile_dir, exist_ok=True)
    path = os.path.join(_profile_dir, f"torch-trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


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
    order, so one in-flight collective per comm is the contract.

    Nonblocking calls have no barrier to block in: ranks deposit under
    ``nb_lock`` into per-sequence call records (``nb_calls``) that the
    segments' polls read; ``nb_bell`` rings the doorbell of every member
    rank's progress engine, where their waits sleep (``bind_universes``
    makes them its followers); ``nb_stream`` the side stream their
    segments run on (made at the first launch on a CUDA device).

    The rendezvous of a comm made by dup, create or split (``bind_derived``)
    lives in the registry ``children`` of the binding's root rendezvous,
    keyed by the new context id and the sorted world ranks of the comm's
    group (the colours of one split share a context id): the first
    member to arrive makes it, the others look it up, each holding one
    reference that ``release`` drops."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots: List = [None] * size
        self.events: List[Optional[torch.cuda.Event]] = [None] * size
        self.result: List = [None] * size
        self.done: Optional[torch.cuda.Event] = None
        self.error: Optional[BaseException] = None
        self.nb_lock = threading.Lock()
        self.nb_calls: Dict[int, dict] = {}
        self.nb_failed = False
        self.nb_bell = Doorbell()
        self.nb_stream = None
        self.child_lock = threading.Lock()
        self.children: Dict[tuple, list] = {}   # key -> [rendezvous, refs]

    def child(self, key: tuple, size: int) -> "_Rendezvous":
        """The derived comm's rendezvous under ``key``, made by the first
        member to ask; one more reference to it."""
        with self.child_lock:
            ent = self.children.get(key)
            if ent is None:
                ent = self.children[key] = [_Rendezvous(size), 0]
                if self.nb_failed:      # made after a rank died
                    ent[0].abort()
            ent[1] += 1
            return ent[0]

    def release(self, key: tuple) -> None:
        """Drop one member's reference; the last removes the entry."""
        with self.child_lock:
            ent = self.children.get(key)
            if ent is not None:
                ent[1] -= 1
                if ent[1] <= 0:
                    del self.children[key]

    def abort(self) -> None:
        """Break the barrier so peers blocked in a device collective see
        a failure instead of deadlocking (called when a rank dies), here
        and in every derived comm's rendezvous. A nonblocking call has no
        barrier to break: the sticky ``nb_failed`` makes every later
        deposit and poll raise MPIX_ERR_PROC_FAILED, and the ring wakes
        the waiters now."""
        self.nb_failed = True
        self.nb_bell.ring()
        self.barrier.abort()
        with self.child_lock:
            kids = [ent[0] for ent in self.children.values()]
        for kid in kids:
            kid.abort()


class _VDeposit:
    """One rank's alltoallv contribution at the rendezvous: its send
    payload packed densely in peer order (peer 0's elements first) and
    its scounts row, from which the leader assembles the count
    matrix."""

    __slots__ = ("data", "scounts")

    def __init__(self, data, scounts):
        self.data = data
        self.scounts = tuple(int(c) for c in scounts)


def _record_event(device: torch.device) -> Optional[torch.cuda.Event]:
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Channel:
    """What the channels share: one rank's place at the rendezvous, the
    execution of a call (deposit, the leader runs the program, pickup),
    its per-call accounting, the MPI-shaped entry points and the device
    NBC tier. A subclass gives ``LEVELS``, ``SUPPORTED``, ``_build``,
    ``_compute`` (the program over a list of deposits, one output a
    rank), ``_leader`` and ``_note_tier``.

    ``derived`` marks the channel of a comm made by dup, create or split
    (``bind_derived``): it runs tensors only, and a call whose buffers
    hold no tensor takes the host tier as the comm would with no
    channel at all (no ``dev_coll_fallback_nbc``, a tensor ``recvbuf``
    with a numpy ``sendbuf`` refused as there)."""

    # a numpy sendbuf of an i-collective rides the NBC tier (the 1:1
    # channel, where the JAX package routes it); on the slot and fold
    # channels it keeps the JAX route, the host schedule
    NB_NUMPY = False
    # the kernel sources a start() of a persistent call may launch
    # (``ops/_build.py`` names), loaded by ``prewarm``
    KERNEL_LIBS: Tuple[str, ...] = ("hbm_slot", "ring")
    derived = False

    # hierarchy levels one call on this channel exercises (the
    # coll_level_* pvars bumped per call in _run)
    LEVELS: Tuple[str, ...] = ()
    # collectives this channel routes to the device; the others keep
    # their host entries, as in the JAX package, for this reason
    SUPPORTED: Tuple[str, ...] = ()
    # collectives the channel runs on the device for a tensor only: a
    # numpy buffer keeps the host tier, where the JAX package's channel
    # runs every call of them
    TENSOR_ONLY: Tuple[str, ...] = ()
    UNSUPPORTED_WHY = ""

    def __init__(self, device: torch.device, rendezvous: _Rendezvous,
                 rank: int, size: int):
        self.device = torch.device(device)
        self.rv = rendezvous
        self.rank = rank
        self.size = size
        self.u = None           # the rank's Universe (bind_universes)
        self.key = None         # (root rendezvous, key) of a derived comm
        self._programs: Dict = {}
        self._nb_seq = 0        # this rank's nonblocking-call sequence

    def abort(self) -> None:
        self.rv.abort()

    def release(self) -> None:
        """``Comm.free`` of a derived comm: drop this member's reference
        to its rendezvous in the root's registry."""
        if self.key is not None:
            root, key = self.key
            self.key = None
            root.release(key)

    def _program(self, name: str, n: int, dtype_str: str, op: str,
                 extra=None):
        """The leader's callable for one signature (``extra``: the count
        matrix of an alltoallv), built once; under MV2T_TRACE its first
        call records the tier instants of ``ops/`` (``trace.lowering``)."""
        key = (name, n, dtype_str, op, extra)
        got = self._programs.get(key)
        if got is None:
            got = self._programs[key] = self._build(name, n, op, extra)
            if self.u.tracer is not None:
                return trace.lowering(self.u.tracer, got)
        return got

    # -- the rendezvous execution ----------------------------------------
    @staticmethod
    def _slot_extent(slot) -> Tuple[int, str]:
        """(n, dtype string) of a deposited slot, without moving it."""
        if isinstance(slot, _VDeposit):
            slot = slot.data
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
        coll_level_* counters, the dev_effbw_<tier> watermark, the
        ``dev_<name>`` span (with an NVTX range on a CUDA device) and the
        lat_dev_<tier> histogram. On a CUDA device the time is the host
        clock around the rendezvous and the enqueue."""
        tier = self._note_tier(name, local, op if name != "bcast" else None)
        for lv in self.LEVELS:
            mpit.pvar(f"coll_level_{lv}").inc()
        n = self._slot_extent(local)[0]
        nbytes = n * _torch_dtype(local).itemsize
        tr = self.u.tracer
        nvtx = tr is not None and self.device.type == "cuda"
        if tr is not None:
            tr.record("device", f"dev_{name}", "B", tier=tier, op=op,
                      bytes=nbytes)
        if nvtx:
            torch.cuda.nvtx.range_push(f"dev_{name}")
        t0 = time.perf_counter()
        try:
            out = self._execute(name, local, op=op, root=root)
        finally:
            dt = time.perf_counter() - t0
            if nvtx:
                torch.cuda.nvtx.range_pop()
            if tr is not None:
                tr.record("device", f"dev_{name}", "E", tier=tier,
                          us=round(dt * 1e6, 3))
        if dt > 0 and nbytes > 0:
            mpit.pvar(f"dev_effbw_{tier}").mark(nbytes / dt / 1e9)
        mx = metrics.LIVE
        if mx is not None:
            mx.rec_us(f"lat_dev_{tier}", dt * 1e6)
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

    # bcast and alltoall keep _run's op, "sum", as the JAX channel's
    # calls do: their dev_<coll> spans record it
    def bcast(self, comm, buf, count, datatype, root):
        out = self._run("bcast", _as_local(buf, buf, count), root=root)
        return _deliver(out, buf)

    def allgather(self, comm, sendbuf, recvbuf, count, datatype):
        local = _as_local(sendbuf, recvbuf, count,
                          in_place_start=comm.rank * count)
        out = self._run("allgather", local, op=None)
        return _deliver(out, recvbuf)

    def alltoall(self, comm, sendbuf, recvbuf, count, datatype):
        local = _as_local(sendbuf, recvbuf, count * comm.size)
        out = self._run("alltoall", local)
        return _deliver(out, recvbuf)

    def reduce_scatter_block(self, comm, sendbuf, recvbuf, count, datatype,
                             op):
        local = _as_local(sendbuf, recvbuf, count * comm.size)
        out = self._run("reduce_scatter_block", local,
                        op=_op_name(op))
        return _deliver(out, recvbuf)

    def alltoallv(self, comm, sendbuf, scounts, sdispls, recvbuf, rcounts,
                  rdispls, datatype):
        """The MoE-shaped variable-count alltoall: each rank packs its
        sends densely and deposits them with its scounts row; the leader
        runs the matrix's program (``_compute_v``); the packed result is
        laid out at the caller's rdispls on the way out."""
        dep = _VDeposit(_pack_v(sendbuf, scounts, sdispls), scounts)
        out = self._run("alltoallv", dep, op=None)
        return _deliver_v(out, recvbuf, rcounts, rdispls)

    def _compute_v(self, deps, dtype: Optional[str] = None) -> List:
        """The alltoallv program over ``deps`` (one ``_VDeposit`` a
        rank): assemble the count matrix from every rank's scounts row
        and hand the packed payloads in place, each at its own length, to
        the matrix's program (K11 over every rank's deposit: on one card
        all of them lie in its memory)."""
        counts = tuple(d.scounts for d in deps)
        dtype = dtype or self._slot_extent(deps[0])[1]
        xs = [_to_device(d.data, self.device).reshape(-1) for d in deps]
        return self._program("alltoallv", 0, dtype, "none", counts)(xs)

    # -- nonblocking device collectives on the NBC DAG -------------------
    # The blocking rendezvous waits at a threading.Barrier, which a DAG
    # vertex must never do. The i-collective is a small DAG instead: a
    # CALL deposits this rank's buffer into a per-sequence call record,
    # one POLL a segment launches it (the first poll past full arrival,
    # on whichever rank) and then reads its CUDA event on every engine
    # pass, and a last CALL lands this rank's result. Compute the rank
    # enqueues between the call and its wait() overlaps the segments.
    # Each channel's segment runs its blocking program (``_compute``) on
    # slices of the staged deposits: the 1:1 channel its ring program,
    # the slot channel K1 (or K11), the fold channel its chip fold (K1)
    # followed by the ring over the folded shards.

    def _nb_segments(self, name: str, n: int,
                     dtype: torch.dtype) -> List[Tuple[int, int]]:
        """[(off, len)] program segments. The elementwise collectives
        (allreduce, bcast) split into segments that complete one by one
        (on the fold channel each segment folds and rings its own slice:
        both stages are elementwise along ``n``); allgather and
        alltoall(v), whose outputs do not split along ``n``, run as
        one."""
        if name not in ("allreduce", "bcast") or n <= 1:
            return [(0, n)]
        cfg = get_config()
        seg_bytes = int(cfg["DEVICE_NBC_SEG_BYTES"])
        if seg_bytes <= 0:
            return [(0, n)]
        seg = max(1, seg_bytes // max(1, dtype.itemsize))
        nseg = min(int(cfg["DEVICE_NBC_MAX_SEGS"]), (n + seg - 1) // seg)
        if nseg <= 1:
            return [(0, n)]
        per = (n + nseg - 1) // nseg
        return [(o, min(per, n - o)) for o in range(0, n, per)]

    def nonblocking(self, comm, name: str, *a, plan: bool = False):
        """The device-tier request of one i-collective (``a``: the
        blocking entry's arguments after the comm), or None when the call
        cannot ride it (``build_nonblocking_request`` counts
        dev_coll_fallback_nbc). ``plan=True`` is the MPI_*_init pre-warm:
        the same routing gates, then ``prewarm`` instead of a request
        (True/False).

        The result lands in ``recvbuf``: a numpy array (device-to-host),
        or a contiguous tensor under a tensor ``sendbuf`` (a copy on the
        card). A numpy ``sendbuf`` rides only where ``NB_NUMPY`` says
        so; MPI_IN_PLACE and a missing ``recvbuf`` never ride."""
        opn, op_sel, root = None, None, 0
        rcounts = rdispls = None
        if name == "allreduce":
            sendbuf, recvbuf, count, datatype, op_sel = a
            opn = _op_name(op_sel)
            if opn is None:
                return None
            send_eff, n = sendbuf, count
            wire = count * datatype.size
        elif name == "bcast":
            buf, count, datatype, root = a
            sendbuf = recvbuf = send_eff = buf
            n = count
            wire = count * datatype.size
        elif name in ("allgather", "alltoall"):
            sendbuf, recvbuf, count, datatype = a
            send_eff = sendbuf
            n = count if name == "allgather" else count * self.size
            wire = count * datatype.size * self.size
        elif name == "alltoallv":
            (sendbuf, scounts, sdispls, recvbuf, rcounts, rdispls,
             datatype) = a
            if sdispls is None:
                sdispls = _dense_displs(scounts)
            if rdispls is None:
                rdispls = _dense_displs(rcounts)
            send_eff, n = sendbuf, int(sum(scounts))
            wire = n * datatype.size
        else:
            return None
        if _is_in_place(sendbuf) or _is_in_place(recvbuf) or recvbuf is None:
            return None
        send_t = is_device_tensor(send_eff)
        if is_device_tensor(recvbuf):
            # a tensor lands on the card: under a tensor sendbuf only (the
            # JAX package's arrays are immutable, so its completion CALL
            # writes through a host recvbuf; a numpy send keeps that)
            if not send_t or not recvbuf.is_contiguous() \
                    or not _dtype_ok(recvbuf):
                return None
        elif not (send_t or self.NB_NUMPY) \
                or not _recv_dtype_ok(recvbuf, send_eff):
            return None
        if not _dtype_ok(send_eff):
            return None
        if _select_transport(name, wire, op_sel, send_eff) != "device":
            return None
        if plan:
            if name == "alltoallv":
                # the count matrix is cross-rank state: the first start()
                # assembles it and builds its program
                return False
            return self.prewarm(name, n, send_eff, opn or "sum")
        if name == "alltoallv":
            local = _VDeposit(_pack_v(sendbuf, scounts, sdispls), scounts)
        else:
            local = _as_local(sendbuf, recvbuf, n)
        return self._build_nonblocking(comm, name, local, opn or "sum",
                                       root, recvbuf, rcounts, rdispls)

    def _build_nonblocking(self, comm, name: str, local, op: str,
                           root: int, recvbuf, rcounts=None, rdispls=None):
        """The i-collective as this rank's DAG (deposit CALL -> one POLL a
        segment -> completion CALL), started on its engine; returns the
        schedule's request."""
        from .nbc import engine as nbc_engine
        from .nbc.dag import SchedDAG
        rv, rank = self.rv, self.rank
        seq = self._nb_seq
        self._nb_seq += 1
        n, dtype_str = self._slot_extent(local)
        dtype = _torch_dtype(local)
        segs = self._nb_segments(name, n, dtype)
        dag = SchedDAG()

        def deposit():
            ev = _record_event(self.device)   # on this rank's stream
            with rv.nb_lock:
                _check_alive(rv, name)
                rec = rv.nb_calls.get(seq)
                if rec is None:
                    k = len(segs)
                    rec = rv.nb_calls[seq] = {
                        "slots": [None] * self.size,
                        "events": [None] * self.size, "arrived": 0,
                        "shards": None, "outs": [None] * k,
                        "done": [None] * k, "t0": [None] * k,
                        "tracer": [None] * k, "landed": [False] * k,
                        "error": None, "picked": 0}
                rec["slots"][rank] = local
                rec["events"][rank] = ev
                rec["arrived"] += 1
            rv.nb_bell.ring()
        dep = dag.call(deposit)
        polls = [dag.poll(lambda si=si, off=off, ln=ln: self._nb_poll(
                     name, seq, si, off, ln, dtype_str, op, root, len(segs)),
                     after=(dep,))
                 for si, (off, ln) in enumerate(segs)]
        dag.call(lambda: self._nb_finish(name, seq, recvbuf, rcounts,
                                         rdispls), after=tuple(polls))
        req = nbc_engine.start(comm, dag, f"dev-i{name}")
        req.device_nbc = True
        return req

    def _nb_poll(self, name: str, seq: int, si: int, off: int, ln: int,
                 dtype_str: str, op: str, root: int, nseg: int) -> bool:
        """One engine pass over a parked segment. False while peers are
        still depositing or the card still runs it; the launch happens
        here, on the first poll past full arrival. Never waits for the
        card: completion is its event's ``query()``."""
        rv = self.rv
        _check_alive(rv, name)
        launched = False
        with rv.nb_lock:
            rec = rv.nb_calls.get(seq)
            if rec is None or rec["arrived"] < self.size:
                return False
            if rec["error"] is not None:
                raise rec["error"]
            if rec["outs"][si] is None:
                try:
                    rec["outs"][si], rec["done"][si] = self._nb_launch(
                        rec, name, off, ln, dtype_str, op, root)
                except BaseException as e:   # every rank's poll raises it
                    rec["error"] = e
                    raise
                rec["t0"][si] = time.perf_counter()
                launched = True
                mpit.pvar("dev_nbc_segments").inc()
                tr = rec["tracer"][si] = self.u.tracer
                if tr is not None:
                    tr.record("device", "nbc_dev_issue", "i", coll=name,
                              seg=si, of=nseg, n=int(ln))
            ev = rec["done"][si]
        if launched:
            rv.nb_bell.ring()
        if ev is not None and not ev.query():
            return False
        with rv.nb_lock:
            if not rec["landed"][si]:
                rec["landed"][si] = True
                dt = time.perf_counter() - rec["t0"][si]
                try:    # a ring kernel's error word, once the card is done
                    ring.raise_pending()
                except RuntimeError as e:
                    rec["error"] = e
                # in the launching rank's recorder, beside its issue, on
                # whichever rank saw the event first
                tr = rec["tracer"][si]
                if tr is not None:
                    tr.record("device", "nbc_dev_complete", "i", coll=name,
                              seg=si, us=round(dt * 1e6, 3))
                mx = metrics.LIVE
                if mx is not None:
                    mx.rec_us("lat_dev_nbc", dt * 1e6)
            if rec["error"] is not None:
                raise rec["error"]
        return True

    def _nb_launch(self, rec: dict, name: str, off: int, ln: int,
                   dtype_str: str, op: str, root: int):
        """Enqueue one segment (under ``nb_lock``, by whichever rank's
        poll got there first) and return (one output per rank, the CUDA
        event after it; None on the CPU). On a CUDA device it runs on the
        rendezvous's side stream: the call's first segment makes it wait
        on every rank's deposit event and stages the deposits once
        (numpy ones through pinned memory, asynchronously; tensors are
        read in place, recorded on the stream so their memory outlives
        the reads); every segment runs the blocking path's program
        (``_compute``) on slices of the staged deposits."""
        rv, dev = self.rv, self.device
        stream = None
        if dev.type == "cuda":
            if rv.nb_stream is None:
                rv.nb_stream = torch.cuda.Stream(dev)
            stream = rv.nb_stream
        with _on_stream(dev, stream):
            if rec["shards"] is None:
                _wait_deposits(dev, rec["events"])
                rec["shards"] = [_nb_stage(s.data if isinstance(
                    s, _VDeposit) else s, dev, stream) for s in rec["slots"]]
            shards = rec["shards"]
            if name == "alltoallv":
                outs = self._compute_v([_VDeposit(sh, s.scounts) for sh, s
                                        in zip(shards, rec["slots"])],
                                       dtype_str)
            else:
                n = shards[0].numel()
                xs = shards if (off, ln) == (0, n) else \
                    [s[off:off + ln] for s in shards]
                # the deposits' dtype names the program, as on the
                # blocking path and in prewarm
                outs = self._compute(name, xs, op, root, dtype_str)
            return outs, _record_event(dev)

    def _nb_finish(self, name: str, seq: int, recvbuf, rcounts,
                   rdispls) -> None:
        """Completion CALL (every segment polled ready): this rank's
        stream waits on the segments' events, then its rows land in
        ``recvbuf`` (device-to-host into a numpy one, a copy on the card
        into a tensor); the record retires when the last rank has picked
        up."""
        rv = self.rv
        with rv.nb_lock:
            rec = rv.nb_calls[seq]
            parts = [out[self.rank] for out in rec["outs"]]
            events = list(rec["done"])
        try:
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                for ev in events:
                    stream.wait_event(ev)
                for part in parts:
                    # allocated on the side stream, read on this one
                    part.record_stream(stream)
            if name != "alltoallv":
                _land(parts, recvbuf)
            elif is_device_tensor(recvbuf):
                _place_v(parts[0].reshape(-1), recvbuf.view(-1), rcounts,
                         rdispls)
            else:
                _deliver_v(parts[0], recvbuf, rcounts, rdispls)
        finally:
            with rv.nb_lock:
                rec["picked"] += 1
                if rec["picked"] >= self.size:
                    rv.nb_calls.pop(seq, None)

    def prewarm(self, name: str, n: int, sendbuf, op: str = "sum") -> bool:
        """Persistent-init hook: build every program signature a start()
        of this call (``n`` elements of ``sendbuf``'s dtype) launches, and
        load the CUDA kernels on a CUDA device (``ops/_build.py``), so
        that no start() pays for a build. Returns False when a build
        fails (a start() then raises on it)."""
        try:
            dtype_str = self._slot_extent(sendbuf)[1]
            for _, ln in self._nb_segments(name, n, _torch_dtype(sendbuf)):
                self._prewarm_program(name, ln, dtype_str, op)
            if self.device.type == "cuda":
                from ..ops import _build
                for lib in self.KERNEL_LIBS:
                    _build.load(lib)
            return True
        except Exception as e:   # noqa: BLE001 - a start() raises on it
            warnings.warn(f"persistent {name} pre-warm failed ({e!r})")
            return False

    def _prewarm_program(self, name: str, n: int, dtype_str: str,
                         op: str) -> None:
        """Build the program of one segment's signature."""
        self._program(name, n, dtype_str, op)


class DeviceCollChannel(_Channel):
    """One rank's handle on the 1:1 mesh channel: rank r owns virtual
    device r of ``mesh``, row-major over its axes.

    The leader's programs (``_build``) on a 1-D mesh:

      * allreduce/reduce: ``ici.ici_all_reduce`` (K6 / K3 / stock, by
        tier), one output row per rank;
      * allgather: ``ici.ici_all_gather`` (K7 / K5 / stock);
      * alltoall: ``alltoall.ici_all_to_all`` (K10 / stock);
      * alltoallv: ``alltoall.ici_all_to_allv`` (K11 / stock) over the
        count matrix the leader assembles from every rank's scounts row
        (``_compute_v``), one program per matrix;
      * bcast: a copy of the root's shard per rank (stock, as the JAX
        package lowers it through XLA);
      * reduce_scatter_block: the stock reduction over the stacked
        shards, then rank r's block (as the JAX program lowers it); a
        bfloat16 one, which the JAX channel keeps on its host tier,
        runs ``ici.ici_reduce_scatter`` (K4).

    On a mesh of two or more axes (``multi_axis``, ``_build_mesh``):
    allreduce/reduce ``ici.ici_all_reduce_mesh``, allgather
    ``ici.ici_all_gather_mesh``, reduce_scatter_block
    ``ici.ici_reduce_scatter_mesh``, bcast the root's shard to every
    rank, alltoall(v) the stock lowering over the flattened axes (the
    JAX program lowers them through XLA there, not through K10/K11).

    The leader waits for each call's device work and raises if a ring
    kernel's spin wait timed out, so every rank of that call raises.
    """

    LEVELS = ("ici",)
    SUPPORTED = ("allreduce", "reduce", "bcast", "allgather", "alltoall",
                 "reduce_scatter_block", "alltoallv")
    NB_NUMPY = True
    KERNEL_LIBS = ("ring",)

    def __init__(self, mesh, rendezvous: _Rendezvous, rank: int,
                 nranks: Optional[int] = None):
        super().__init__(mesh.device, rendezvous, rank,
                         mesh.size if nranks is None else nranks)
        self.mesh = mesh
        self.axes: Tuple[str, ...] = tuple(mesh.axis_names)

    @property
    def multi_axis(self) -> bool:
        return len(self.axes) > 1

    def _axis_sizes(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((a, self.mesh.shape[a]) for a in self.axes)

    def _mesh_extent(self) -> int:
        """Participant count of the mesh program: the rank count on the
        1:1 binding, the device count on the fold channel."""
        return self.mesh.size

    def _build(self, name: str, n: int, op: str, extra=None):
        """The leader's program for one signature: a callable taking the
        mesh's flat shards and the root, returning one output per mesh
        rank. ``_note_tier`` counts the call's tier on every rank."""
        if self.multi_axis:
            return self._build_mesh(name, n, op, extra)
        p = self._mesh_extent()
        if name in ("allreduce", "reduce"):
            def f(xs, root):
                return list(ici.ici_all_reduce(xs, op).unbind(0))
        elif name == "allgather":
            def f(xs, root):
                return list(ici.ici_all_gather(xs).unbind(0))
        elif name == "alltoall":
            def f(xs, root):
                return list(alltoall.ici_all_to_all(xs).unbind(0))
        elif name == "alltoallv":
            counts = extra                  # the static p x p matrix

            def f(xs, root=0):
                return alltoall.ici_all_to_allv(xs, counts)
        elif name == "bcast":
            def f(xs, root):
                return list(xs[root].reshape(1, n).expand(p, n).clone()
                            .unbind(0))
        elif name == "reduce_scatter_block":
            c = n // p

            def f(xs, root):
                if xs[0].dtype == torch.bfloat16:
                    # the JAX program takes no bf16: the ring kernel K4
                    return list(ici.ici_reduce_scatter(xs, op).unbind(0))
                y = ici.stock_reduce(torch.stack(xs), op)
                return [y[r * c:(r + 1) * c] for r in range(p)]
        else:  # pragma: no cover
            raise KeyError(name)
        return f

    def _build_mesh(self, name: str, n: int, op: str, extra=None):
        """Multi-axis programs: the reductions and the allgather ride the
        per-axis ring phases (``ici_*_mesh``); bcast and alltoall(v) are
        stock, as the JAX program lowers them through XLA."""
        axes, p = self._axis_sizes(), self._mesh_extent()
        if name in ("allreduce", "reduce"):
            def f(xs, root):
                return ici.ici_all_reduce_mesh(xs, axes, op)
        elif name == "allgather":
            def f(xs, root):
                return ici.ici_all_gather_mesh(xs, axes)
        elif name == "reduce_scatter_block":
            def f(xs, root):
                return ici.ici_reduce_scatter_mesh(xs, axes, op)
        elif name == "bcast":
            def f(xs, root):
                return list(xs[root].reshape(1, n).expand(p, n).clone()
                            .unbind(0))
        elif name == "alltoall":
            def f(xs, root):
                return list(alltoall.stock_all_to_all(xs).unbind(0))
        elif name == "alltoallv":
            counts = extra

            def f(xs, root=0):
                return alltoall.stock_all_to_allv(xs, counts)
        else:  # pragma: no cover
            raise KeyError(name)
        return f

    def _compute(self, name: str, slots, op: str, root: int,
                 dtype: Optional[str] = None) -> List:
        """The program over the ``p`` deposits, read in place: one
        output per rank."""
        if name == "alltoallv":
            return self._compute_v(slots, dtype)
        n, got = self._slot_extent(slots[0])
        dtype = dtype or got
        xs = [_to_device(s, self.device).reshape(n) for s in slots]
        return self._program(name, n, dtype, op)(xs, root)

    def _leader(self, name: str, op: str, root: int) -> List:
        """Leader compute: order this stream after every deposit, run the
        program over them (``_compute``), then wait for it and raise on
        a ring kernel's spin timeout."""
        _wait_deposits(self.device, self.rv.events)
        out = self._compute(name, self.rv.slots, op, root)
        ring.check_errors(self.device)
        return out

    def _note_tier(self, name: str, local, op: Optional[str]) -> str:
        """Count which tier THIS call runs (dev_coll_tier_{vmem,hbm,quant},
        or dev_coll_fallback_<reason> when the stock lowering is taken)
        and return its label ('vmem'/'hbm'/'quant'/'xla'), keyed as the
        JAX package's: the tier ``planned_tier`` names for the call's
        shard bytes on this mesh's ranks (output bytes for allgather; for
        alltoall(v) the tier of ``planned_a2a_tier`` on this rank's send
        bytes), over the mesh extent (the device count on the fold
        channel; allgather's bytes are the rank count's), and on a
        multi-axis mesh for the whole payload, not per phase. A quant
        call also adds the wire bytes it saves (``wire_stats``) to
        dev_coll_quant_bytes_saved. A fallback also drops a
        ``dev_coll_fallback`` instant (``coll``, ``nbytes``, ``reason``)
        under MV2T_TRACE."""
        n, _ = self._slot_extent(local)
        dtype = _torch_dtype(local)
        p = self._mesh_extent()
        nbytes = n * dtype.itemsize * (self.size if name == "allgather"
                                       else 1)
        if name in ("alltoall", "alltoallv"):
            tier, reason = alltoall.planned_a2a_tier(max(1, nbytes), dtype)
        elif name in ("allreduce", "reduce", "allgather"):
            tier, reason = ici.planned_tier(name, nbytes, dtype, op,
                                            num_devices=p)
        else:
            return "xla"    # collectives without a kernel lowering
        if reason is None:
            mpit.pvar(f"dev_coll_tier_{tier}").inc()
            if tier == "quant":
                exact_b, wire_b = quant.wire_stats(n, dtype, p)
                mpit.pvar("dev_coll_quant_bytes_saved").inc(
                    max(0, exact_b - wire_b))
            return tier
        mpit.pvar(f"dev_coll_fallback_{reason}").inc()
        tr = self.u.tracer
        if tr is not None:
            tr.record("channel", "dev_coll_fallback", "i", coll=name,
                      nbytes=nbytes, reason=reason)
        return "xla"


class DeviceFoldChannel(DeviceCollChannel):
    """Leaders per chip: ``n`` ranks over a mesh of ``ndev`` devices, ``1 <
    ndev < n``, ``k = n // ndev`` ranks a device, rank r on device
    ``r // k`` (blocked, so a device's ranks own contiguous result
    blocks). Each collective runs in two levels:

      * the chip fold: a device's ``k`` deposits fold to one ``[n]``
        contribution (``_reduce_deposits``): K1 over the deposits in
        place for sum, the stock reduction over them stacked ``(k, n)``
        for max/min/prod; with ``k == 1`` the deposit passes through.
        allgather concatenates the ``k`` deposits (the blocked layout
        keeps rank order); bcast takes the root rank's deposit on the
        root's device;
      * the ICI phase: the 1:1 channel's program, 1-D or multi-axis, over
        the ``ndev`` device shards (``_mesh_extent``).

    The ranks of a device SHARE its output tensor, as the slot channel
    shares its result: a rank must not write it in place (reduce_scatter_
    block hands each rank its own slice of it). alltoall(v) has no fold
    composition (per-peer payloads cross devices pairwise), and the JAX
    package keeps it on the host tier. On one card every rank's deposit
    lies in the card's memory, so a tensor's alltoall runs K10 and its
    alltoallv K11 over all ``n`` ranks' deposits, flat (``_build``); a
    numpy buffer keeps the host tier. A failed K1 raises out of the
    collective (the JAX package demotes its fold to XLA)."""

    LEVELS = ("chip", "ici")
    SUPPORTED = ("allreduce", "reduce", "bcast", "allgather",
                 "reduce_scatter_block")
    TENSOR_ONLY = ("alltoall", "alltoallv")
    UNSUPPORTED_WHY = ("on the leaders-per-chip fold channel: a numpy "
                       "buffer keeps the host tier, as in the JAX package "
                       "(per-peer payloads have no fold composition)")
    NB_NUMPY = False
    KERNEL_LIBS = ("hbm_slot", "ring")

    def __init__(self, mesh, rendezvous: _Rendezvous, rank: int,
                 nranks: int):
        super().__init__(mesh, rendezvous, rank, nranks)
        self.ndev = mesh.size
        self.k = nranks // self.ndev
        self.chip = rank // self.k

    def _mesh_extent(self) -> int:
        return self.ndev

    def _build(self, name: str, n: int, op: str, extra=None):
        """alltoall(v) over every rank's deposit, flat (K10 / K11 by the
        1-D tier pick, whatever the device mesh's axes); the other
        collectives the mesh program over the folded device shards."""
        if name == "alltoall":
            def f(xs, root=0):
                return list(alltoall.ici_all_to_all(xs).unbind(0))
        elif name == "alltoallv":
            counts = extra

            def f(xs, root=0):
                return alltoall.ici_all_to_allv(xs, counts)
        else:
            return super()._build(name, n, op, extra)
        return f

    def _prewarm_program(self, name: str, n: int, dtype_str: str,
                         op: str) -> None:
        """The mesh program of a segment: over ``k * n`` for allgather,
        whose device shards concatenate their ranks' deposits."""
        self._program(name, n * self.k if name == "allgather" else n,
                      dtype_str, op)

    def _fold_chip(self, slots, j: int, n: int, op: str) -> torch.Tensor:
        """Device ``j``'s ``k`` deposits folded to one ``[n]`` shard."""
        sl = slots[j * self.k:(j + 1) * self.k]
        if self.k == 1:
            return _to_device(sl[0], self.device).reshape(n)
        return _reduce_deposits(sl, n, self.device, op)

    def _compute(self, name: str, slots, op: str, root: int,
                 dtype: Optional[str] = None) -> List:
        """Fold per device, run the mesh program over the folded shards,
        fan each device's output back to its ranks (alltoall(v): the
        flat program over every rank's deposit)."""
        nd, k = self.ndev, self.k
        if name == "alltoallv":
            return self._compute_v(slots, dtype)
        n, got = self._slot_extent(slots[0])
        dtype = dtype or got
        prog_root, prog_n = 0, n
        if name == "alltoall":      # every rank a participant, flat
            return self._program(name, n, dtype, op)(
                [_to_device(s, self.device).reshape(n) for s in slots])
        if name == "bcast":
            # only the root device's shard matters: the root rank's
            # payload there, zeros elsewhere (the program overwrites them)
            prog_root = root // k
            root_x = _to_device(slots[root], self.device).reshape(n)
            xs = [root_x if j == prog_root else torch.zeros_like(root_x)
                  for j in range(nd)]
        elif name == "allgather":
            prog_n = k * n
            xs = [_stack_slots(slots[j * k:(j + 1) * k], n,
                               self.device).reshape(prog_n)
                  for j in range(nd)]
        else:   # allreduce / reduce / reduce_scatter_block
            xs = [self._fold_chip(slots, j, n, op) for j in range(nd)]
        out = self._program(name, prog_n, dtype, op)(xs, prog_root)
        if name == "reduce_scatter_block":
            # a device's block holds its k ranks' contiguous blocks
            c = n // nd // k
            return [out[r // k].reshape(-1)[(r % k) * c:(r % k + 1) * c]
                    for r in range(self.size)]
        return [out[r // k] for r in range(self.size)]

    def _leader(self, name: str, op: str, root: int) -> List:
        """Leader compute: order this stream after every deposit, fold and
        run the mesh program (``_compute``), then wait for it and raise
        on a ring kernel's spin timeout."""
        _wait_deposits(self.device, self.rv.events)
        out = self._compute(name, self.rv.slots, op, root)
        ring.check_errors(self.device)
        return out


def _reduce_deposits(slots, n: int, device: torch.device,
                     op: str) -> torch.Tensor:
    """``len(slots)`` deposits of ``n`` elements reduced to one ``[n]`` on
    ``device``. A sum of tensors on ``device`` (at most
    ``hbm.MAX_SLOTS``) goes to K1 by address: each deposit is read where
    it lies, with no staging copy. The deposits are the ranks' own
    tensors, read on the leader's stream once it has waited on every
    deposit's event, and every rank's stream waits on the leader's
    ``rv.done`` before its collective returns (``_Channel._execute``), so
    no rank writes or frees a deposit while K1 reads it. Host (numpy)
    deposits, tensors on another device, more than ``hbm.MAX_SLOTS`` and
    the stock max/min/prod are staged once into a stacked ``(len, n)``:
    K1's strided form for sum, the stock reduction otherwise."""
    if op == "sum" and len(slots) <= hbm.MAX_SLOTS and all(
            is_device_tensor(s) and s.device == device for s in slots):
        return hbm.hbm_slot_allreduce([s.reshape(n) for s in slots])
    x = _stack_slots(slots, n, device)
    if op == "sum":
        return hbm.hbm_slot_allreduce(x)
    return ici.stock_reduce(x, op)


def _stack_slots(slots, n: int, device: torch.device) -> torch.Tensor:
    """Deposits as one planar ``(len, n)`` tensor on ``device`` (one
    host-side stack and one transfer for host deposits)."""
    if all(is_device_tensor(s) for s in slots):
        return torch.stack([_to_device(s, device).reshape(n) for s in slots])
    return _to_device(np.stack([np.asarray(s).reshape(n) for s in slots]),
                      device)


class HBMSlotChannel(_Channel):
    """All bound ranks share ONE device: collectives run through an
    on-card slot segment (``ops/hbm.py``). Every rank deposits at the
    rendezvous and the leader runs one program:

      * allreduce/reduce: one slot-reduce pass (K1) over the R deposits,
        read in place by address (``_reduce_deposits``), writing the
        result ONCE; the broadcast is zero-copy: every rank is handed the
        SAME result tensor, which is shared and must not be written in
        place;
      * allgather: the leader stages one planar ``(R, n)`` slot tensor,
        which *is* the result (no device compute);
      * alltoall: one transpose of the staged slot tensor;
      * alltoallv of a tensor: K11 over the R deposits read in place by
        the count matrix's tile table (``_compute_v``); a numpy buffer
        keeps the host tier, as in the JAX package;
      * reduce_scatter_block: slot-reduce (K1), then per-rank slices;
      * bcast: a copy of the root slot, shared by all ranks.

    ``sum`` runs K1 (on a CUDA device it launches the kernel or raises);
    ``max``/``min``/``prod`` take the stock torch reduction over the
    staged slots, as the JAX channel takes XLA's for them.
    """

    LEVELS = ("chip",)
    SUPPORTED = ("allreduce", "reduce", "bcast", "allgather", "alltoall",
                 "reduce_scatter_block")
    TENSOR_ONLY = ("alltoallv",)
    UNSUPPORTED_WHY = ("on the single-device slot channel: a numpy buffer "
                       "keeps the host tier, as in the JAX package")

    def _note_tier(self, name: str, local, op: Optional[str]) -> str:
        return "slot"       # single-device slot channel: no ring tiers

    def _build(self, name: str, n: int, op: str, extra=None):
        R = self.size
        if name in ("allreduce", "reduce", "reduce_scatter_block"):
            def f(slots):                   # the R deposits -> [n]
                return _reduce_deposits(slots, n, self.device, op)
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
        elif name == "alltoallv":
            counts = extra                  # the static R x R matrix

            def f(xs):                      # R packed payloads, in place
                return alltoall.hbm_alltoallv(xs, counts)
        else:  # pragma: no cover
            raise KeyError(name)
        return f

    def _compute(self, name: str, slots, op: str, root: int,
                 dtype: Optional[str] = None) -> List:
        """Hand the deposits to the reduction (or stage the planar slot
        tensor on the device), run the program, share or scatter the
        result."""
        R = self.size
        if name == "alltoallv":
            return self._compute_v(slots, dtype)
        n, got = self._slot_extent(slots[root])
        dtype = dtype or got
        if name == "bcast":
            # a copy: the shared result must not alias the root's buffer
            x = _to_device(slots[root], self.device).reshape(n).clone()
        elif name in ("allreduce", "reduce", "reduce_scatter_block"):
            x = slots
        else:
            x = _stack_slots(slots, n, self.device)
        out = self._program(name, n, dtype, op)(x)
        if name == "alltoall":
            return [out[r] for r in range(R)]
        if name == "reduce_scatter_block":
            c = n // R
            return [out[r * c:(r + 1) * c] for r in range(R)]
        # the zero-copy share: every rank gets the same tensor
        return [out] * R

    def _leader(self, name: str, op: str, root: int) -> List:
        """Leader compute: order this stream after every deposit, then
        the program (``_compute``)."""
        _wait_deposits(self.device, self.rv.events)
        return self._compute(name, self.rv.slots, op, root)


def _wait_deposits(device: torch.device, events) -> None:
    """Order the leader's stream after every rank's deposit."""
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        for ev in events:
            if ev is not None:
                stream.wait_event(ev)


def _check_alive(rv: _Rendezvous, name: str) -> None:
    if rv.nb_failed:
        raise MPIException(MPIX_ERR_PROC_FAILED,
                           f"device nonblocking {name}: a peer rank failed")


def _on_stream(device: torch.device, stream):
    """``stream`` made current on ``device`` (nothing on the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.cuda.device(device))
    ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def _nb_stage(slot, device: torch.device, stream) -> torch.Tensor:
    """One deposit as a flat tensor on ``device``, for a segment on
    ``stream`` (the current stream): a tensor there as it is, recorded on
    the stream; a numpy deposit copied through pinned memory without
    waiting for the card (the host allocator keeps the pinned block until
    the copy is done)."""
    if is_device_tensor(slot):
        t = _to_device(slot, device).reshape(-1)
        if stream is not None:
            t.record_stream(stream)
        return t
    host = torch.from_numpy(np.ascontiguousarray(slot).reshape(-1))
    if stream is None:
        return host if device.type == "cpu" else host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _land(parts: List[torch.Tensor], recvbuf) -> None:
    """This rank's result, one part a segment in order, into ``recvbuf``
    (on the current stream): a contiguous tensor by a copy a part; a
    numpy array device-to-host, straight into a contiguous buffer of the
    result's dtype, else through ``_deliver``."""
    if is_device_tensor(recvbuf):
        _place(parts, recvbuf.view(-1))
        return
    dst = np.asarray(recvbuf)
    n = sum(p.numel() for p in parts)
    flat = None
    if dst.flags.c_contiguous and dst.flags.writeable and dst.size >= n:
        try:
            flat = torch.from_numpy(dst.reshape(-1))
        except TypeError:      # a numpy dtype torch does not map
            flat = None
    if flat is None or flat.dtype != parts[0].dtype:
        _deliver(parts[0] if len(parts) == 1 else
                 torch.cat([p.reshape(-1) for p in parts]), recvbuf)
        return
    _place(parts, flat)


def _place(parts: List[torch.Tensor], flat: torch.Tensor) -> None:
    """The parts, in order, copied into the front of ``flat``."""
    off = 0
    for p in parts:
        flat[off:off + p.numel()].copy_(p.reshape(-1))
        off += p.numel()


def _place_v(packed, flat, rcounts, rdispls) -> None:
    """A packed alltoallv result (dense sender order) written into
    ``flat`` (a tensor or a numpy array of the same kind) at
    ``rdispls``; the gaps keep their values."""
    off = 0
    for j, cnt in enumerate(rcounts):
        flat[rdispls[j]:rdispls[j] + cnt] = packed[off:off + cnt]
        off += cnt


def _torch_dtype(buf) -> torch.dtype:
    if isinstance(buf, _VDeposit):
        buf = buf.data
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
    host = to_host(out.reshape(-1))     # bf16 as ml_dtypes' bfloat16
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


def _dense_displs(counts) -> List[int]:
    """Dense prefix displacements (the packed layout)."""
    out, off = [], 0
    for c in counts:
        out.append(off)
        off += int(c)
    return out


def _pack_v(sendbuf, scounts, sdispls):
    """This rank's alltoallv sends packed densely in peer order (the
    layout K11's tables assume). A dense layout is a view, no copy."""
    total = int(sum(scounts))
    dense = list(sdispls) == _dense_displs(scounts)
    if is_device_tensor(sendbuf):
        flat = sendbuf.reshape(-1)
        if dense:
            return flat[:total]
        parts = [flat[sdispls[j]:sdispls[j] + scounts[j]]
                 for j in range(len(scounts)) if scounts[j]]
        return torch.cat(parts) if parts else flat[:0]
    arr = np.asarray(sendbuf).reshape(-1)
    if dense:
        return np.ascontiguousarray(arr[:total])
    parts = [arr[sdispls[j]:sdispls[j] + scounts[j]]
             for j in range(len(scounts)) if scounts[j]]
    return (np.ascontiguousarray(np.concatenate(parts)) if parts
            else arr[:0].copy())


def _deliver_v(out, recvbuf, rcounts, rdispls):
    """Lay the packed result (dense sender order) out at the caller's
    rdispls: into a numpy recvbuf (device-to-host), or as a tensor
    returned to the caller (tensor or absent recvbuf)."""
    rtotal = int(sum(rcounts))
    dense = list(rdispls) == _dense_displs(rcounts)
    flat = out.reshape(-1)
    if recvbuf is None or is_device_tensor(recvbuf):
        if dense:
            return flat[:rtotal]
        ext = max((rdispls[j] + rcounts[j] for j in range(len(rcounts))),
                  default=0)
        dst = torch.zeros(ext, dtype=flat.dtype, device=flat.device)
    else:
        flat = to_host(flat)
        dst = np.asarray(recvbuf).reshape(-1)
    _place_v(flat, dst, rcounts, rdispls)
    return dst if is_device_tensor(dst) else None


# ---------------------------------------------------------------------------
# per-comm install
# ---------------------------------------------------------------------------

# wrapper name -> cvar prefix (reduce_scatter_block shares the
# REDUCE_SCATTER override and alltoallv the ALLTOALL one, matching the
# MPI-level collective family)
_CVAR_OF = {"allreduce": "ALLREDUCE", "bcast": "BCAST",
            "allgather": "ALLGATHER", "alltoall": "ALLTOALL",
            "alltoallv": "ALLTOALL",
            "reduce": "REDUCE", "reduce_scatter_block": "REDUCE_SCATTER"}

def _route(name: str, nbytes: int, op, buf) -> Tuple[str, str]:
    """('device', '') or ('host', why) for this call, as the JAX
    package's ``_select_transport`` chooses. A forced
    ``<COLL>_ALGO=device`` wins over everything but an op or dtype that
    does not lower (which logs a warning and takes the host); another
    forced algorithm, ``USE_DEVICE_COLL`` off or such an op or dtype
    take the host; then a tensor and alltoallv take the device, and a
    numpy buffer takes it from DEVICE_COLL_MIN_BYTES (``nbytes``: the
    call's bytes on the wire) up. The decision must be identical on
    every rank of a call: its inputs are required-uniform by MPI, buffer
    residency included. alltoallv's send total is not (a zero row is
    legal), so it has no size gate. 'host' is a routing decision, never
    taken after a device failure: a kernel that does not build or launch
    raises out of the collective."""
    cfg = get_config()
    forced = cfg.get(f"{_CVAR_OF[name]}_ALGO", "")
    why = ""
    if op is not None and _op_name(op) is None:
        why = f"op {op!r} has no device reduction"
    elif not _dtype_ok(buf):
        why = (f"dtype {getattr(buf, 'dtype', type(buf).__name__)} does "
               f"not run on the device channel (8-byte, bool and complex "
               f"types, and a numpy bfloat16 array, take the host tier, as "
               f"in the JAX package)")
    if forced == "device":
        if why:
            log.warning("%s forced to device but op/dtype does not lower; "
                        "using host path", name)
            return "host", why
        return "device", ""
    if forced:              # a named host algorithm wins
        return "host", f"host algorithm {forced!r} forced"
    if not cfg["USE_DEVICE_COLL"]:
        return "host", "USE_DEVICE_COLL is off"
    if why:
        return "host", why
    if is_device_tensor(buf) or name == "alltoallv":
        return "device", ""
    crossover = int(cfg["DEVICE_COLL_MIN_BYTES"])
    if nbytes >= crossover:
        return "device", ""
    return "host", (f"{nbytes} bytes are below DEVICE_COLL_MIN_BYTES "
                    f"({crossover})")


def _select_transport(name: str, nbytes: int, op, buf) -> str:
    """'device' or 'host' for this call (see :func:`_route`)."""
    return _route(name, nbytes, op, buf)[0]


def _dtype_ok(buf) -> bool:
    """True when ``buf``'s dtype runs on the device channels: integer and
    float kinds of at most 4 bytes, and a bfloat16 tensor (the kernels
    take bf16). A numpy bfloat16 array (ml_dtypes' kind 'V') keeps the
    host tier, as in the JAX package."""
    if not hasattr(buf, "dtype"):
        return False
    if isinstance(buf, torch.Tensor) and buf.dtype == torch.bfloat16:
        return True
    return _dtype_lowers(*_dtype_kind(buf))


def _recv_dtype_ok(recvbuf, send) -> bool:
    """The device NBC tier's test of its numpy ``recvbuf``: a dtype that
    lowers, or ml_dtypes' bfloat16 under a bfloat16 tensor ``send`` (the
    blocking calls' rule keys on the send buffer)."""
    if _dtype_ok(recvbuf):
        return True
    return (isinstance(send, torch.Tensor) and send.dtype == torch.bfloat16
            and dtmod.BFLOAT16.basic is not None
            and np.dtype(recvbuf.dtype) == dtmod.BFLOAT16.basic)


def _refuse_card(name: str, why: str, *bufs) -> None:
    """Raise for a tensor on the card that a call sends to the host tier:
    the port has no device path for it, and the host tier does not move
    it to the host and back."""
    for b in bufs:
        if on_card(b):
            raise NotImplementedError(
                f"{name}: {why}; a tensor on {b.device} has no device "
                f"path for this call and is not moved to the host")


def install_device_coll(comm, channel: _Channel) -> None:
    """Overwrite the device-capable entries of ``comm.coll_fns`` with
    transport-selecting wrappers (the JAX ``install_device_coll``): the
    host entries ``install_coll_ops`` put there run what ``_route`` keeps
    on the host. A tensor on the card that such a call is given raises
    (``_refuse_card``); a CPU tensor is read in place as numpy and the
    result handed back as a CPU tensor, as the JAX package stages a
    device array."""
    from .tuning import install_coll_ops
    if not comm.coll_fns:
        install_coll_ops(comm)
    host = dict(comm.coll_fns)
    comm.device_channel = channel
    sz = comm.size
    # per entry: (bytes on the wire, position of the op, the result's
    # element count) from its args after the comm (core/comm.py
    # signatures), as the JAX install_device_coll's meta table
    meta = {
        "allreduce": (lambda a: a[2] * a[3].size, 4, lambda a: a[2]),
        "reduce": (lambda a: a[2] * a[3].size, 4, lambda a: a[2]),
        "bcast": (lambda a: a[1] * a[2].size, None, lambda a: a[1]),
        "allgather": (lambda a: a[2] * a[3].size * sz, None,
                      lambda a: a[2] * sz),
        "alltoall": (lambda a: a[2] * a[3].size * sz, None,
                     lambda a: a[2] * sz),
        "reduce_scatter_block": (lambda a: a[2] * a[3].size * sz, 4,
                                 lambda a: a[2]),
    }

    def wrap(name):
        hostfn = host[name]
        tensor_only = name in channel.TENSOR_ONLY or channel.derived
        devfn = getattr(channel, name) \
            if name in channel.SUPPORTED or tensor_only else None
        nbytes_of, op_pos, out_count_of = meta[name]

        def entry(comm_, *a):
            buf = a[0]
            if _is_in_place(buf) and len(a) > 1:
                buf = a[1]       # selection looks at the effective buffer
            if devfn is None or (tensor_only and not is_device_tensor(buf)):
                why = f"{name} {channel.UNSUPPORTED_WHY}"
            else:
                op = a[op_pos] if op_pos is not None else None
                where, why = _route(name, nbytes_of(a), op, buf)
                if where == "device":
                    return devfn(comm_, *a)
            # the host tier: numpy buffers as they are; a CPU tensor read
            # as numpy, its result handed back as a CPU tensor
            if name == "bcast":
                _refuse_card(name, why, a[0])
                if not is_device_tensor(a[0]):
                    return hostfn(comm_, *a)
                h = to_host(a[0])
                hostfn(comm_, h, *a[1:])
                return from_host(h, a[0].device)
            send, recv = a[0], a[1]
            _refuse_card(name, why, send, recv)
            if not (is_device_tensor(send) or is_device_tensor(recv)):
                return hostfn(comm_, *a)
            if _is_in_place(send) and is_device_tensor(recv):
                raise ValueError("MPI_IN_PLACE with a tensor recvbuf is "
                                 "not supported on the host transport")
            send_h = to_host(send) if is_device_tensor(send) else send
            recv_h = recv
            if recv_h is None or is_device_tensor(recv_h):
                if name == "reduce" and comm_.rank != a[5]:
                    recv_h = None
                else:
                    recv_h = np.empty((out_count_of(a),),
                                      dtype=np.asarray(send_h).dtype)
            hostfn(comm_, send_h, recv_h, *a[2:])
            if recv_h is None:
                return None
            return from_host(recv_h, "cpu")
        return entry

    for name in meta:
        comm.coll_fns[name] = wrap(name)

    # alltoallv: its own wrapper (recvbuf sits at a[3], and the decision
    # keys on this rank's send total). The device tier needs a channel
    # that runs it (the 1:1 mesh; the slot and fold channels for a
    # tensor only, keeping the host path for numpy), and MPI_IN_PLACE
    # takes the host.
    host_a2av = host["alltoallv"]
    supported = "alltoallv" in channel.SUPPORTED and not channel.derived
    tensor_only = "alltoallv" in channel.TENSOR_ONLY or channel.derived

    def a2av_entry(comm_, sendbuf, scounts, sdispls, recvbuf, rcounts,
                   rdispls, datatype):
        if not (supported or (tensor_only and is_device_tensor(sendbuf))):
            why = f"alltoallv {channel.UNSUPPORTED_WHY}"
        elif _is_in_place(sendbuf):
            why = "alltoallv with MPI_IN_PLACE takes the host tier"
        else:
            nbytes = int(sum(scounts)) * datatype.size
            where, why = _route("alltoallv", nbytes, None, sendbuf)
            if where == "device":
                return channel.alltoallv(
                    comm_, sendbuf, list(scounts),
                    list(sdispls) if sdispls is not None
                    else _dense_displs(scounts),
                    recvbuf, list(rcounts),
                    list(rdispls) if rdispls is not None
                    else _dense_displs(rcounts), datatype)
        _refuse_card("alltoallv", why, sendbuf, recvbuf)
        if is_device_tensor(sendbuf) or is_device_tensor(recvbuf):
            raise ValueError(f"alltoallv: {why}; tensor buffers need the "
                             f"device transport")
        return host_a2av(comm_, sendbuf, scounts, sdispls, recvbuf,
                         rcounts, rdispls, datatype)
    comm.coll_fns["alltoallv"] = a2av_entry


def build_nonblocking_request(comm, name: str, *a):
    """The i-collective's device-tier request, or None when ``comm`` has
    no device channel or the call cannot ride the tier; a call the
    channel refuses counts dev_coll_fallback_nbc and takes the host
    schedule (``coll/nonblocking.py``), as in the JAX package; a tensor
    on the card in such a call raises (``_refuse_card``). A kernel
    that fails to build or launch raises out of the request's wait():
    unlike the JAX package, an error in the routing itself is not turned
    into a host schedule either."""
    channel = comm.device_channel
    if channel is None or _numpy_on_derived(channel, a):
        return None
    req = channel.nonblocking(comm, name, *a)
    if req is None:
        mpit.pvar("dev_coll_fallback_nbc").inc()
        _refuse_card(f"i{name}", "the device NBC tier does not take this "
                     "call (the host schedule would)", *a)
    return req


def prewarm_persistent(comm, name: str, *a) -> bool:
    """MPI_*_init hook (``core/comm.py`` ``_coll_init``): when a start()
    of this persistent collective routes to the device tier, build its
    programs and load the kernels now (``DeviceCollChannel.prewarm``)."""
    channel = comm.device_channel
    if channel is None or _numpy_on_derived(channel, a):
        return False
    return bool(channel.nonblocking(comm, name, *a, plan=True))


def _numpy_on_derived(channel: _Channel, args) -> bool:
    """A call of a derived comm whose buffers hold no tensor: the host
    tier, as the comm would take it with no channel."""
    return channel.derived and not any(is_device_tensor(b) for b in args)


# ---------------------------------------------------------------------------
# binding (harness entry point)
# ---------------------------------------------------------------------------

def bind_universes(universes, device: torch.device, mesh=None) -> bool:
    """Bind each thread-rank universe's COMM_WORLD. Geometry selects the
    channel, as in the JAX package:

      * a mesh of as many devices as universes -> DeviceCollChannel
        (1:1, on a 1-D or a multi-axis mesh);
      * ``1 < devices < ranks`` with ``ranks % devices == 0`` ->
        DeviceFoldChannel (leaders per chip);
      * a one-device mesh under several ranks, or no mesh ->
        HBMSlotChannel on ``device`` (all ranks share it; with no mesh
        this holds for one rank too).

    Any other mesh binds nothing and returns False: COMM_WORLD keeps the
    host tier, as in the JAX package (which logs a warning). Under
    MV2T_JAX_PROFILE the first binding starts the profiler bracket."""
    n = len(universes)
    rv = _Rendezvous(n)
    if mesh is None or (mesh.size == 1 and n > 1):
        device = device if mesh is None else mesh.device
        binding = _Binding(rv, device, None, [0] * n)

        def make(r):
            return HBMSlotChannel(device, rv, r, n)
    elif mesh.size == n:
        binding = _Binding(rv, mesh.device, mesh, list(range(n)))

        def make(r):
            return DeviceCollChannel(mesh, rv, r)
    elif 1 < mesh.size < n and n % mesh.size == 0:
        binding = _Binding(rv, mesh.device, mesh,
                           [r // (n // mesh.size) for r in range(n)])

        def make(r):
            return DeviceFoldChannel(mesh, rv, r, n)
    else:
        log.warning("mesh shape %s does not match %d ranks; host path "
                    "only", dict(mesh.shape), n)
        return False
    for r, u in enumerate(universes):
        ch = make(r)
        ch.u = u
        # the rendezvous's rings wake every member rank's waits
        rv.nb_bell.followers.append(u.engine.bell)
        install_device_coll(u.comm_world, ch)
        u.device_binding = binding
    out_dir = get_config()["JAX_PROFILE"]
    if out_dir and _profiler is None:
        _start_profile(out_dir)
    return True


class _Binding:
    """What ``bind_universes`` bound, shared by the ranks of one run: the
    root rendezvous (whose registry holds the derived comms'), the
    device, the mesh (None on the slot channel) and each world rank's
    virtual device (its flat index in the mesh; 0 for every rank on the
    slot channel)."""

    __slots__ = ("rv", "device", "mesh", "vdev")

    def __init__(self, rv: _Rendezvous, device: torch.device, mesh,
                 vdev: List[int]):
        self.rv = rv
        self.device = device
        self.mesh = mesh
        self.vdev = vdev


def _derived_geometry(devs: List[int]) -> Tuple[Optional[str], object]:
    """The geometry rule of ``bind_universes`` over the members' virtual
    devices in rank order: ('slot', 1) when they share one device,
    ('mesh', k) when each of the k members has its own, ('fold', d) when
    d devices hold equal contiguous runs of members; else (None, why)."""
    k = len(devs)
    uniq = list(dict.fromkeys(devs))
    d = len(uniq)
    if d == 1:
        return "slot", 1
    if d == k:
        return "mesh", k
    if k % d == 0 and all(devs[i] == uniq[i // (k // d)] for i in range(k)):
        return "fold", d
    return None, (f"its {k} members lie on virtual devices {devs}: neither "
                  f"one device, one member a device, nor equal contiguous "
                  f"runs of members a device")


def bind_derived(comm) -> None:
    """Give a comm made by dup, create, split or split_type_shared of a
    bound run its device channel: the geometry rule of
    ``bind_universes`` applied to its members' virtual devices, in the
    comm's rank order (``_derived_geometry``). One device: the slot
    channel over its ``k`` ranks (K1 over ``k`` deposits); ``k``
    devices: the 1:1 channel over a 1-D mesh of ``k`` virtual devices
    (the run's own mesh, multi-axis too, when the members are its
    devices in order); ``d`` devices holding equal contiguous runs: the
    fold channel over ``d`` (likewise). Any other geometry binds
    nothing, and the comm's refusal of a tensor on the card names it
    (``unbound_why``). So does a comm with members that are not ranks
    of the bound run (a comm merged from a spawn intercomm,
    ``core/intercomm.py``): every member binds nothing. A comm derived
    from a derived comm follows the same rule; an intercomm never binds
    a channel.

    Every member computes the same rendezvous key, the context id and
    the sorted world ranks of the group, and takes the rendezvous from
    the root's registry (``_Rendezvous.child``); ``Comm.free`` drops the
    reference (``_Channel.release``). The channel is ``derived``: it
    takes tensors only, and a numpy call runs the host tier as the comm
    would with no channel. Binding allocates nothing on the card and
    launches nothing."""
    b = getattr(comm.u, "device_binding", None)
    if b is None:
        return
    members = [comm.group.world_of_rank(i) for i in range(comm.size)]
    outside = [w for w in members if not 0 <= w < len(b.vdev)]
    if outside:
        # members the run never bound (ranks spawned into a comm merged
        # from a spawn intercomm) have no virtual device: every member
        # binds nothing, so none waits at a rendezvous the others skip
        comm.unbound_why = (f"its members {outside} are not ranks of the "
                            f"bound run (spawned processes) and have no "
                            f"virtual device")
        return
    devs = [b.vdev[w] for w in members]
    kind, arg = _derived_geometry(devs)
    if kind is None:
        comm.unbound_why = arg
        return
    from ..parallel.mesh import make_mesh
    key = (comm.context_id, tuple(sorted(members)))
    rv = b.rv.child(key, comm.size)
    if kind == "slot":
        ch = HBMSlotChannel(b.device, rv, comm.rank, comm.size)
    else:
        heads = list(dict.fromkeys(devs))
        mesh = b.mesh if heads == list(range(b.mesh.size)) \
            else make_mesh((arg,), ("x",), b.device)
        if kind == "mesh":
            ch = DeviceCollChannel(mesh, rv, comm.rank)
        else:
            ch = DeviceFoldChannel(mesh, rv, comm.rank, comm.size)
    ch.derived = True
    ch.u = comm.u
    ch.key = (b.rv, key)
    rv.nb_bell.followers.append(comm.u.engine.bell)
    install_device_coll(comm, ch)
