"""Device-resident RMA windows: one-sided ops on device memory over a
mesh (counterpart of ``mvapich2_tpu/rma/device.py``, the direct-RDMA
analog of the reference's ``gen2/rdma_iba_1sc.c``).

* A ``DeviceWin`` is a ``(p, n)`` tensor on the mesh's device, row r
  rank r's exposed window memory; ``p`` is the extent of the comm's
  axis, on a 1-D mesh or one axis of a multi-axis mesh.
* ``put`` / ``get`` / ``accumulate`` enqueue descriptors; the closing
  synchronization call applies them in queue order, each on a tier
  (``ops/rma.py`` ``planned_rma_tier``):

  - **rdma**: the kernels K12 ``rma_put``, K13 ``rma_get`` (direct
    copies) and K14 ``rma_accumulate`` (a direct fold; ``ops/rma.py``),
    one launch an op;
  - **quant**: an f32 accumulate that MV2T_QUANT_COLL and
    DEV_RMA_QUANT_MIN send to K14's quantized wire, K14q
    (``rma_accumulate(quantized=True)``), one launch an op;
  - **epoch**: stock torch indexing on the window rows (slices, and
    ``index_copy_`` for strided ops), the port's counterpart of the JAX
    ppermute epoch compiler; for strided ops, bool and complex windows,
    and payloads that are empty or below DEV_RMA_RDMA_MIN.

  Every op is counted: ``dev_rma_tier_rdma`` or ``dev_rma_tier_quant``
  and ``dev_rma_wire_bytes`` (the payload, or the wire words' bytes of a
  quantized op) on the kernels, ``dev_rma_tier_epoch`` and
  ``dev_rma_fallback_<reason>`` on the epoch tier.
* Synchronization grammar: ``fence()`` closes everything enqueued
  (MPI_Win_fence); ``lock(rank)`` / ``unlock(rank)`` bound a
  passive-target epoch on one rank, ``flush(rank)`` / ``flush_local``
  complete that rank's queued ops mid-epoch and leave the others queued
  (MPI_Win_lock family). Each ends with the completion wave,
  ``ops/ring.check_errors``: the stream is drained and a kernel's spin
  timeout raises. Local and remote completion coincide, so
  ``flush_local`` is ``flush``.

The driving program is global (it sees every rank), so descriptors carry
explicit origin and target ranks. Ops run on the current stream of the
window's device, looked up once a wave, with the device made current
once for the wave; MPI's rule that an origin buffer stays untouched until
its epoch closes holds here too (a device tensor payload is read at the
closing call, not copied at enqueue). A payload that partly overlaps
the range it writes (a view of the window) is copied when its op runs,
on every tier, so the op writes the values it held, as the JAX
package's immutable payloads do.

Observability, as in the JAX module: in a traced rank thread
(``runtime.universe.current_universe()`` with a recorder) each completion
wave is a ``device``-lane ``rma_fence`` or ``rma_flush`` B/E span (``nops``,
and ``rank`` on a flush, -1 for all ranks), with an NVTX range beside it
on a CUDA device; ``lock`` and ``unlock`` drop ``rma_lock`` /
``rma_unlock`` instants (``rank``), and each op served by a kernel tier an
``rma_put`` / ``rma_get`` / ``rma_acc`` instant (``tier``, ``bytes``,
``origin``, ``target``) inside its wave. Every wave records its time in
the ``lat_rma_flush`` histogram (``metrics.LIVE``).

``direct_put`` (K17, the port of ``pallas_put``) is the ops-level
single-shot put into a window tensor; as in the JAX package it is not on
``DeviceWin``'s dispatch.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Tuple

import torch

from .. import metrics, mpit
from ..ops import ring
from ..ops import rma
from ..ops.rma import direct_put  # noqa: F401  (K17, pallas_put's port)
from ..runtime.universe import current_universe


def _recorder():
    """The calling rank thread's event recorder (None when untraced or
    outside a rank thread)."""
    u = current_universe()
    return u.tracer if u is not None else None

class DeviceWin:
    """An MPI-style window whose memory is a ``(p, n)`` tensor on the
    mesh's device (``comm``: a ``parallel.mesh.MeshComm`` over one axis,
    ``p`` that axis's extent: on a multi-axis mesh the JAX window's rows
    are sharded over the axis and copied over the others, one window of
    ``p`` rows either way).

    Ops enqueued inside an epoch are applied, in order, at the closing
    sync call; ``get`` results become available after it through the
    handle's ``value()``. 8-byte dtypes raise ``NotImplementedError``
    (the port's device kernels take at most 4 bytes an element)."""

    def __init__(self, comm, n: int, dtype: torch.dtype = torch.float32):
        if dtype.itemsize == 8 and not dtype.is_complex:
            raise NotImplementedError(f"DeviceWin: 8-byte dtype {dtype}")
        if comm.multi_axis:
            raise NotImplementedError(
                f"DeviceWin over a comm that spans the axes {comm.axes} of "
                f"{comm.mesh}: a window takes the ranks of one axis (the "
                f"JAX DeviceWin shards its rows over the first axis only "
                f"and raises IndexError at its first closing call)")
        self.comm = comm
        self.p = comm.size
        self.n = int(n)
        self.dtype = dtype
        self.device = comm.device
        self.win = torch.zeros((self.p, self.n), dtype=dtype,
                               device=self.device)
        # queue entries: (op descriptor, payload tensor|None, handle|None)
        self._queue: List[tuple] = []
        self._locked: set = set()   # ranks under a passive access epoch

    # -- local access -----------------------------------------------------
    def local(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s window contents (a host copy)."""
        return self.win[rank].to("cpu", copy=True)

    def store(self, rank: int, disp: int, values) -> None:
        """Local store into one rank's window region (outside epochs)."""
        vals = self._payload(values)
        rma.check_range(self.n, disp, vals.numel(), 1, "store")
        self.win[rank, disp:disp + vals.numel()] = rma.unshared(
            vals, self.win, rank, disp)

    # -- one-sided ops (enqueue; applied at the closing sync call) --------
    def put(self, src, origin: int, target: int, disp: int = 0,
            stride: int = 1) -> None:
        """MPI_Put. ``stride`` > 1 writes every stride-th window element
        starting at ``disp`` (the vector-datatype case, always on the
        epoch tier)."""
        src = self._payload(src)
        self._enqueue(("put", origin, target, disp, src.numel(),
                       int(stride)), src, None)

    def accumulate(self, src, origin: int, target: int, disp: int = 0,
                   stride: int = 1) -> None:
        """MPI_Accumulate with MPI_SUM (the only op the device tiers take,
        as in the JAX package)."""
        src = self._payload(src)
        self._enqueue(("acc", origin, target, disp, src.numel(),
                       int(stride)), src, None)

    def get(self, n: int, origin: int, target: int, disp: int = 0,
            stride: int = 1) -> "_GetHandle":
        h = _GetHandle(n)
        self._enqueue(("get", origin, target, disp, int(n), int(stride)),
                      None, h)
        return h

    def _payload(self, src) -> torch.Tensor:
        return torch.as_tensor(src, dtype=self.dtype,
                               device=self.device).reshape(-1)

    def _enqueue(self, op, pay, h) -> None:
        kind, origin, target, disp, n, stride = op
        for rank in (origin, target):
            if not 0 <= rank < self.p:
                raise ValueError(f"{kind}: rank {rank} outside the "
                                 f"window's {self.p} ranks")
        rma.check_range(self.n, disp, n, stride, kind)
        self._queue.append((op, pay, h))

    # -- synchronization ---------------------------------------------------
    def fence(self) -> None:
        """Close the active-target access epoch: apply every enqueued op
        (one completion wave), publish get results."""
        if not self._queue:
            return
        self._wave(list(range(len(self._queue))), "rma_fence",
                   nops=len(self._queue))

    def lock(self, rank: int) -> None:
        """Open an exclusive passive-target access epoch on ``rank``
        (MPI_Win_lock). One program drives every rank, so the lock is
        epoch bookkeeping: locking a locked rank raises."""
        if rank in self._locked:
            raise RuntimeError(f"rank {rank} already locked")
        self._locked.add(rank)
        rec = _recorder()
        if rec is not None:
            rec.record("device", "rma_lock", "i", rank=rank)

    def unlock(self, rank: int) -> None:
        """Close the passive epoch on ``rank``: flush its outstanding ops
        (the completion wave), then release (MPI_Win_unlock)."""
        if rank not in self._locked:
            raise RuntimeError(f"rank {rank} not locked")
        self.flush(rank)
        self._locked.discard(rank)
        rec = _recorder()
        if rec is not None:
            rec.record("device", "rma_unlock", "i", rank=rank)

    def flush(self, rank: Optional[int] = None) -> None:
        """Complete every outstanding op targeting ``rank`` (None = all
        ranks) at origin and target (MPI_Win_flush); ops for other
        targets stay queued (MPI makes no cross-target ordering
        promise)."""
        idx = [i for i, (op, _pay, _h) in enumerate(self._queue)
               if rank is None or op[2] == rank]
        if not idx:
            return
        mpit.pvar("dev_rma_flush").inc()
        self._wave(idx, "rma_flush", rank=-1 if rank is None else rank,
                   nops=len(idx))

    def flush_local(self, rank: Optional[int] = None) -> None:
        """MPI_Win_flush_local: local completion coincides with remote
        completion here, so one wave."""
        self.flush(rank)

    # -- dispatch ----------------------------------------------------------
    def _wave(self, idx: List[int], span: str, **args) -> None:
        """One completion wave over the queue entries at ``idx`` inside
        the ``span`` B/E span, timed into ``lat_rma_flush``."""
        mx = metrics.LIVE
        t0 = time.perf_counter() if mx is not None else 0.0
        rec = _recorder()
        nvtx = rec is not None and self.device.type == "cuda"
        if rec is not None:
            rec.record("device", span, "B", **args)
        if nvtx:
            torch.cuda.nvtx.range_push(span)
        try:
            self._dispatch(idx, rec)
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
            if rec is not None:
                rec.record("device", span, "E")
            if mx is not None:
                mx.rec_since("lat_rma_flush", t0)

    def _op_tier(self, op) -> Tuple[str, Optional[str]]:
        kind, _origin, _target, _disp, n, stride = op
        return rma.planned_rma_tier(kind, n * self.dtype.itemsize,
                                    self.dtype, stride == 1, self.p,
                                    count=n)

    def _dispatch(self, idx: List[int], rec) -> None:
        """Apply the queue entries at ``idx`` in order, each on its tier
        (planned for all of them first, so a call that raises applies
        nothing), then run the completion wave. ``rec``: the wave's
        recorder, or None."""
        entries = [self._queue[i] for i in idx]
        tiers = [self._op_tier(op) for op, _pay, _h in entries]
        stream, current = None, contextlib.nullcontext()
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device).cuda_stream
            current = torch.cuda.device(self.device)
        with current:
            for (op, pay, h), (tier, reason) in zip(entries, tiers):
                nbytes = op[4] * self.dtype.itemsize
                if tier == "epoch":
                    mpit.pvar("dev_rma_tier_epoch").inc()
                    rma.note_rma_fallback(op[0], reason, nbytes)
                    self._run_epoch(op, pay, h)
                else:
                    wire = nbytes
                    if tier == "quant":
                        wire = rma.wire_words(
                            op[4], rma.quant_block_elems(self.dtype)) * 4
                    mpit.pvar(f"dev_rma_tier_{tier}").inc()
                    mpit.pvar("dev_rma_wire_bytes").inc(wire)
                    if rec is not None:
                        rec.record("device", f"rma_{op[0]}", "i", tier=tier,
                                   bytes=nbytes, origin=op[1], target=op[2])
                    self._run_rdma(tier, op, pay, h, stream)
        done = set(idx)
        self._queue = [e for i, e in enumerate(self._queue)
                       if i not in done]
        ring.check_errors(self.device)

    # -- the kernel tier --------------------------------------------------
    def _run_rdma(self, tier: str, op, pay, h,
                  stream: Optional[int]) -> None:
        """One op on a kernel; ``stream``: the wave's stream handle (None
        on the CPU)."""
        kind, origin, target, disp, n, _stride = op
        if kind == "get":
            h._value = rma.rma_get(self.win, n, origin, target, disp,
                                   stream=stream)
        elif kind == "put":
            rma.rma_put(pay, self.win, origin, target, disp, stream=stream)
        else:
            rma.rma_accumulate(pay, self.win, origin, target, disp,
                               quantized=tier == "quant", stream=stream)

    # -- the epoch tier ---------------------------------------------------
    def _run_epoch(self, op, pay, h) -> None:
        """One op in stock torch on the target's row: a slice for stride
        1, an index for strided ops; a get reads with the same index."""
        kind, _origin, target, disp, n, stride = op
        row = self.win[target]
        if stride == 1:
            idx = slice(disp, disp + n)
        else:
            idx = disp + stride * torch.arange(n, device=self.device)
        if kind == "get":
            h._value = row[idx].clone()
            return
        if kind == "put":
            new = rma.unshared(pay, self.win, target, disp,
                               stride * (n - 1) + 1)
        else:
            new = rma.add_values(row[idx], pay)
        if stride == 1:
            row[idx] = new
        elif row.dtype in ring.WIDE:
            # torch on the CPU has no index_copy_ for uint16/uint32:
            # move the bits through the same-width signed view
            signed = torch.int16 if row.dtype == torch.uint16 else \
                torch.int32
            row.view(signed).index_copy_(0, idx, new.view(signed))
        else:
            row.index_copy_(0, idx, new)


class _GetHandle:
    def __init__(self, n: int):
        self.n = n
        self._value: Optional[torch.Tensor] = None

    def value(self) -> torch.Tensor:
        if self._value is None:
            raise RuntimeError("get not yet completed (close the epoch: "
                               "fence, or flush/unlock the target)")
        return self._value
