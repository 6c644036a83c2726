"""The device-collective channels behind the MPI seam (counterpart of the
JAX package's ``coll/device.py``).

A device-bound ``Comm`` gets its ``coll_fns`` entries replaced by
wrappers that run the collective on the device. Ranks are threads of one
process (the ``run_ranks`` harness); a collective call is executed once:
every rank deposits its buffer at a rendezvous, rank 0 (the leader) runs
the device program, every rank picks up its result.

Three bindings are ported, chosen by geometry (``bind_universes``):

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
  a device share its output;
* :class:`HBMSlotChannel`: all ranks share one device and collectives
  run through an on-card slot segment (``ops/hbm.py``).

Nonblocking collectives and the host algorithm tier are not ported; a
call that the JAX package's
``_select_transport`` sends to the host tier (an 8-byte dtype or a
user-defined op, also under a forced ``<COLL>_ALGO=device``; a forced
host algorithm; ``USE_DEVICE_COLL`` off without ``<COLL>_ALGO=device``;
a numpy buffer below ``DEVICE_COLL_MIN_BYTES``; alltoallv with
``MPI_IN_PLACE``, on the slot channel, or alltoall(v) on the fold
channel) raises ``NotImplementedError``, as does a mesh that neither
covers the ranks one to one nor divides them (the JAX package's host
path).

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
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import metrics, mpit, trace
from ..core import op as opmod
from ..ops import alltoall, hbm, ici, quant, ring
from ..utils import is_device_tensor
from ..utils.config import get_config


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
    """What both channels share: one rank's place at the rendezvous, the
    execution of a call (deposit, the leader runs the program, pickup),
    its per-call accounting, and the MPI-shaped entry points. A subclass
    gives ``LEVELS``, ``SUPPORTED``, ``_build``, ``_leader`` and
    ``_note_tier``."""

    # hierarchy levels one call on this channel exercises (the
    # coll_level_* pvars bumped per call in _run)
    LEVELS: Tuple[str, ...] = ()
    # collectives this channel routes to the device; the others raise,
    # with this reason (the JAX package keeps them on its host path)
    SUPPORTED: Tuple[str, ...] = ()
    UNSUPPORTED_WHY = ""

    def __init__(self, device: torch.device, rendezvous: _Rendezvous,
                 rank: int, size: int):
        self.device = torch.device(device)
        self.rv = rendezvous
        self.rank = rank
        self.size = size
        self.u = None           # the rank's Universe (bind_universes)
        self._programs: Dict = {}

    def abort(self) -> None:
        self.rv.abort()

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
        (``_leader_v``), one program per matrix;
      * bcast: a copy of the root's shard per rank (stock, as the JAX
        package lowers it through XLA);
      * reduce_scatter_block: the stock reduction over the stacked
        shards, then rank r's block.

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

            def f(xs, root):
                return alltoall.ici_all_to_allv(xs, counts)
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

            def f(xs, root):
                return alltoall.stock_all_to_allv(xs, counts)
        else:  # pragma: no cover
            raise KeyError(name)
        return f

    def _leader(self, name: str, op: str, root: int) -> List:
        """Leader compute: order this stream after every deposit, hand
        the ``p`` shards in place to the program (one output per rank),
        then wait for it and raise on a ring kernel's spin timeout."""
        rv = self.rv
        _wait_deposits(self.device, rv.events)
        if name == "alltoallv":
            return self._leader_v()
        n, dtype = self._slot_extent(rv.slots[0])
        xs = [_to_device(s, self.device).reshape(n) for s in rv.slots]
        out = self._program(name, n, dtype, op)(xs, root)
        ring.check_errors(self.device)
        return out

    def _leader_v(self) -> List:
        """Leader compute for alltoallv: assemble the count matrix from
        every rank's scounts row and hand the packed payloads in place,
        each at its own length, to the matrix's program."""
        rv = self.rv
        counts = tuple(s.scounts for s in rv.slots)
        _, dtype = self._slot_extent(rv.slots[0])
        xs = [_to_device(s.data, self.device).reshape(-1) for s in rv.slots]
        out = self._program("alltoallv", 0, dtype, "none", counts)(xs, 0)
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

    def alltoallv(self, comm, sendbuf, scounts, sdispls, recvbuf, rcounts,
                  rdispls, datatype):
        """The MoE-shaped variable-count alltoall: each rank packs its
        sends densely and deposits them with its scounts row; the leader
        runs the matrix's program; the packed result is laid out at the
        caller's rdispls on the way out."""
        dep = _VDeposit(_pack_v(sendbuf, scounts, sdispls), scounts)
        out = self._run("alltoallv", dep, op=None)
        return _deliver_v(out, recvbuf, rcounts, rdispls)


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
    composition (per-peer payloads cross devices pairwise) and keeps the
    host path in the JAX package, so it raises here. A failed K1 raises
    out of the collective (the JAX package demotes its fold to XLA)."""

    LEVELS = ("chip", "ici")
    SUPPORTED = ("allreduce", "reduce", "bcast", "allgather",
                 "reduce_scatter_block")
    UNSUPPORTED_WHY = ("on the leaders-per-chip fold channel: per-peer "
                       "payloads cross devices pairwise, which has no fold "
                       "composition")

    def __init__(self, mesh, rendezvous: _Rendezvous, rank: int,
                 nranks: int):
        super().__init__(mesh, rendezvous, rank, nranks)
        self.ndev = mesh.size
        self.k = nranks // self.ndev
        self.chip = rank // self.k

    def _mesh_extent(self) -> int:
        return self.ndev

    def _fold_chip(self, j: int, n: int, op: str) -> torch.Tensor:
        """Device ``j``'s ``k`` deposits folded to one ``[n]`` shard."""
        sl = self.rv.slots[j * self.k:(j + 1) * self.k]
        if self.k == 1:
            return _to_device(sl[0], self.device).reshape(n)
        return _reduce_deposits(sl, n, self.device, op)

    def _leader(self, name: str, op: str, root: int) -> List:
        """Leader compute: fold per device, run the mesh program over the
        folded shards, fan each device's output back to its ranks."""
        rv = self.rv
        nd, k = self.ndev, self.k
        _wait_deposits(self.device, rv.events)
        n, dtype = self._slot_extent(rv.slots[0])
        prog_root, prog_n = 0, n
        if name == "bcast":
            # only the root device's shard matters: the root rank's
            # payload there, zeros elsewhere (the program overwrites them)
            prog_root = root // k
            root_x = _to_device(rv.slots[root], self.device).reshape(n)
            xs = [root_x if j == prog_root else torch.zeros_like(root_x)
                  for j in range(nd)]
        elif name == "allgather":
            prog_n = k * n
            xs = [_stack_slots(rv.slots[j * k:(j + 1) * k], n,
                               self.device).reshape(prog_n)
                  for j in range(nd)]
        else:   # allreduce / reduce / reduce_scatter_block
            xs = [self._fold_chip(j, n, op) for j in range(nd)]
        out = self._program(name, prog_n, dtype, op)(xs, prog_root)
        ring.check_errors(self.device)
        if name == "reduce_scatter_block":
            # a device's block holds its k ranks' contiguous blocks
            c = n // nd // k
            return [out[r // k].reshape(-1)[(r % k) * c:(r % k + 1) * c]
                    for r in range(self.size)]
        return [out[r // k] for r in range(self.size)]


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
      * reduce_scatter_block: slot-reduce (K1), then per-rank slices;
      * bcast: a copy of the root slot, shared by all ranks.

    ``sum`` runs K1 (on a CUDA device it launches the kernel or raises);
    ``max``/``min``/``prod`` take the stock torch reduction over the
    staged slots, as the JAX channel takes XLA's for them.
    """

    LEVELS = ("chip",)
    SUPPORTED = ("allreduce", "reduce", "bcast", "allgather", "alltoall",
                 "reduce_scatter_block")
    UNSUPPORTED_WHY = ("on the single-device slot channel: per-peer "
                       "counts have no slot transpose")

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
        else:  # pragma: no cover
            raise KeyError(name)
        return f

    def _leader(self, name: str, op: str, root: int) -> List:
        """Leader compute: order this stream after every deposit, hand the
        deposits to the reduction (or stage the planar slot tensor on the
        device), run the program, share or scatter the result."""
        rv = self.rv
        R = self.size
        _wait_deposits(self.device, rv.events)
        n, dtype = self._slot_extent(rv.slots[root])
        if name == "bcast":
            # a copy: the shared result must not alias the root's buffer
            x = _to_device(rv.slots[root], self.device).reshape(n).clone()
        elif name in ("allreduce", "reduce", "reduce_scatter_block"):
            x = rv.slots
        else:
            x = _stack_slots(rv.slots, n, self.device)
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
        flat = flat.cpu().numpy()
        dst = np.asarray(recvbuf).reshape(-1)
    off = 0
    for j, cnt in enumerate(rcounts):
        dst[rdispls[j]:rdispls[j] + cnt] = flat[off:off + cnt]
        off += cnt
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

_HOST_TIER = "the host collective tier is not ported"


def _select_transport(name: str, nbytes: int, op, buf) -> str:
    """The transport for this call, as the JAX package's
    ``_select_transport`` chooses it: 'device', or NotImplementedError
    where it would take its host tier. A forced ``<COLL>_ALGO=device``
    wins over everything but an op or dtype that does not lower; another
    forced algorithm, ``USE_DEVICE_COLL`` off or such an op or dtype
    take the host; then a tensor (device-resident) and alltoallv take
    the device, and a numpy buffer takes it from DEVICE_COLL_MIN_BYTES
    (``nbytes``: the call's bytes on the wire) up. The decision must be
    identical on every rank of a call: its inputs are required-uniform
    by MPI, buffer residency included. alltoallv's send total is not
    (a zero row is legal), so it has no size gate."""
    cfg = get_config()
    forced = cfg.get(f"{_CVAR_OF[name]}_ALGO", "")
    if op is not None and _op_name(op) is None:
        raise NotImplementedError(
            f"{name}: op {op!r} has no device reduction; {_HOST_TIER}")
    if not _dtype_ok(buf):
        raise NotImplementedError(
            f"{name}: dtype {getattr(buf, 'dtype', type(buf).__name__)} "
            f"does not run on the device (8-byte, bool and complex types "
            f"need the host tier); {_HOST_TIER}")
    if forced == "device":
        return "device"
    if forced:
        raise NotImplementedError(
            f"{name}: host algorithm {forced!r} forced; {_HOST_TIER}")
    if not cfg["USE_DEVICE_COLL"]:
        raise NotImplementedError(
            f"{name}: USE_DEVICE_COLL is off; {_HOST_TIER}")
    if is_device_tensor(buf) or name == "alltoallv":
        return "device"
    crossover = int(cfg["DEVICE_COLL_MIN_BYTES"])
    if nbytes >= crossover:
        return "device"
    raise NotImplementedError(
        f"{name}: a host buffer of {nbytes} bytes is below "
        f"DEVICE_COLL_MIN_BYTES ({crossover}); {_HOST_TIER}")


def _dtype_ok(buf) -> bool:
    if not hasattr(buf, "dtype"):
        return False
    return _dtype_lowers(*_dtype_kind(buf))


def install_device_coll(comm, channel: _Channel) -> None:
    """Point the device-capable entries of ``comm.coll_fns`` at the
    channel, behind the transport check."""
    comm.device_channel = channel
    sz = comm.size
    # per entry: (bytes on the wire, position of the op) from its args
    # after the comm (core/comm.py signatures; a datatype is a numpy or
    # torch dtype), as the JAX install_device_coll's meta table
    meta = {
        "allreduce": (lambda a: a[2] * a[3].itemsize, 4),
        "reduce": (lambda a: a[2] * a[3].itemsize, 4),
        "bcast": (lambda a: a[1] * a[2].itemsize, None),
        "allgather": (lambda a: a[2] * a[3].itemsize * sz, None),
        "alltoall": (lambda a: a[2] * a[3].itemsize * sz, None),
        "reduce_scatter_block": (lambda a: a[2] * a[3].itemsize * sz, 4),
    }

    def wrap(name):
        devfn = getattr(channel, name)
        nbytes_of, op_pos = meta[name]

        def entry(comm_, *a):
            buf = a[0]
            if _is_in_place(buf) and len(a) > 1:
                buf = a[1]   # selection looks at the effective buffer
            op = a[op_pos] if op_pos is not None else None
            _select_transport(name, nbytes_of(a), op, buf)
            return devfn(comm_, *a)
        return entry

    def host_only(name):
        def entry(comm_, *a):
            raise NotImplementedError(
                f"{name} {channel.UNSUPPORTED_WHY}; {_HOST_TIER}")
        return entry

    for name in meta:
        comm.coll_fns[name] = (wrap(name) if name in channel.SUPPORTED
                               else host_only(name))

    # alltoallv: its own entry (recvbuf sits at a[3]). A channel without
    # it, MPI_IN_PLACE and a forced host algorithm take the host path in
    # the JAX package: here they raise.
    def a2av_entry(comm_, sendbuf, scounts, sdispls, recvbuf, rcounts,
                   rdispls, datatype):
        if "alltoallv" not in channel.SUPPORTED:
            raise NotImplementedError(
                f"alltoallv {channel.UNSUPPORTED_WHY}; {_HOST_TIER}")
        if _is_in_place(sendbuf):
            raise NotImplementedError(
                f"alltoallv with MPI_IN_PLACE; {_HOST_TIER}")
        _select_transport("alltoallv", 0, None, sendbuf)
        return channel.alltoallv(
            comm_, sendbuf, list(scounts),
            list(sdispls) if sdispls is not None
            else _dense_displs(scounts),
            recvbuf, list(rcounts),
            list(rdispls) if rdispls is not None
            else _dense_displs(rcounts), datatype)
    comm.coll_fns["alltoallv"] = a2av_entry


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

    Any other mesh raises ``NotImplementedError``: the JAX package runs
    such a geometry on its host path, which is not ported. Under
    MV2T_JAX_PROFILE the first binding starts the profiler bracket."""
    n = len(universes)
    rv = _Rendezvous(n)
    if mesh is None or (mesh.size == 1 and n > 1):
        device = device if mesh is None else mesh.device

        def make(r):
            return HBMSlotChannel(device, rv, r, n)
    elif mesh.size == n:
        def make(r):
            return DeviceCollChannel(mesh, rv, r)
    elif 1 < mesh.size < n and n % mesh.size == 0:
        def make(r):
            return DeviceFoldChannel(mesh, rv, r, n)
    else:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices {dict(mesh.shape)} neither "
            f"binds {n} ranks one to one nor divides them; the JAX "
            f"package takes its host path there, which is not ported")
    for r, u in enumerate(universes):
        ch = make(r)
        ch.u = u
        install_device_coll(u.comm_world, ch)
    out_dir = get_config()["JAX_PROFILE"]
    if out_dir and _profiler is None:
        _start_profile(out_dir)
    return True
