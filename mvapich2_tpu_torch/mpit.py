"""Performance variables the port bumps (a minimal copy of the JAX
package's ``mpit.py`` pvar registry, under the same names):

* ``coll_level_chip`` / ``coll_level_ici`` - counters: collective calls
  on the slot channel / on the 1:1 mesh channel;
* ``dev_coll_tier_{vmem,hbm,quant}`` - counters: mesh-channel calls per
  planned kernel tier; ``dev_coll_quant_bytes_saved`` - the bytes the
  quant tier's calls kept off the wire, a rank;
  ``dev_coll_fallback_{size,dtype,shape}`` - calls
  that took the stock torch lowering instead, by reason (the JAX
  package counts its XLA takes the same way; it has no
  ``dev_coll_tier_xla``); ``dev_coll_fallback_nbc`` - nonblocking calls
  that could not ride the device tier;
* ``dev_nbc_segments`` and ``dev_persistent_starts`` - counters of the
  nonblocking device collectives: segments launched, persistent starts
  on the device tier; ``nbc_*`` (``coll/nbc/engine.py``) - the NBC
  engine's schedules in flight (a level), vertices issued, doorbell
  wakeups and futile passes;
* ``dev_effbw_<tier>`` - high-watermarks: the best per-call rate (GB/s)
  on a tier, payload bytes over the host-clock time of the collective;
* ``dev_rma_tier_{rdma,quant,epoch}``, ``dev_rma_fallback_{noncontig,
  platform,size,dtype}``, ``dev_rma_flush`` and ``dev_rma_wire_bytes`` -
  counters of the one-sided device windows (``rma/device.py``);
* ``lat_dev_{vmem,hbm,quant,xla,slot}``, ``lat_dev_nbc``,
  ``lat_rma_flush`` and ``lat_coll_sched`` - histograms: log2-bucketed
  latencies in microseconds of each device collective call by tier, of
  each nonblocking segment from its launch to its observed completion,
  of each one-sided completion wave and of each host bcast and allreduce
  algorithm (recorded through ``metrics.LIVE``);
* the host tier's, declared where they are bumped:
  ``coll_<coll>_<algo>_calls`` and ``_time`` (a counter and a timer of
  seconds, ``coll/api.py`` ``_select``), ``pt2pt_eager_sent``,
  ``pt2pt_rndv_sent`` and ``pt2pt_bytes_sent``
  (``pt2pt/protocol.py``), ``recvq_*`` (``pt2pt/matching.py``),
  ``chan_local_{msgs,bytes}_sent`` (``transport/base.py``) and
  ``progress_polls`` (``transport/progress.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

PVAR_CLASS_COUNTER = 0
PVAR_CLASS_TIMER = 1
PVAR_CLASS_LEVEL = 2
PVAR_CLASS_HIGHWATERMARK = 3
PVAR_CLASS_HISTOGRAM = 4
HIST_BUCKETS = 32


class PVar:
    """One performance variable, bumped by the instrumented code."""

    def __init__(self, name: str, klass: int, desc: str = ""):
        self.name = name
        self.klass = klass
        self.desc = desc
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def mark(self, v: float) -> None:
        """High-watermark update."""
        with self._lock:
            if v > self._value:
                self._value = v

    def read(self) -> float:
        with self._lock:
            return self._value

    class _Timer:
        """Adds the seconds of a ``with`` block to a timer pvar."""

        __slots__ = ("pv", "t0")

        def __init__(self, pv: "PVar"):
            self.pv = pv

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.pv.inc(time.perf_counter() - self.t0)
            return False

    def timing(self) -> "PVar._Timer":
        return PVar._Timer(self)


class HistPVar(PVar):
    """A log2-bucketed value distribution, latency in integer
    microseconds by convention: bucket 0 holds values <= 0, bucket i >= 1
    holds [2**(i-1), 2**i - 1], the last bucket saturates (the JAX
    package's buckets). ``read`` is the record count."""

    def __init__(self, name: str, klass: int, desc: str = ""):
        super().__init__(name, klass, desc)
        self.buckets = [0] * HIST_BUCKETS
        self.count = 0
        self.sum = 0

    def rec(self, v: int) -> None:
        i = min(v.bit_length(), HIST_BUCKETS - 1) if v > 0 else 0
        with self._lock:
            self.buckets[i] += 1
            self.sum += max(v, 0)
            self.count += 1

    def snapshot(self) -> tuple:
        """(count, sum, a copy of the buckets)."""
        with self._lock:
            return self.count, self.sum, list(self.buckets)

    def read(self) -> float:
        return float(self.count)


_pvars: Dict[str, PVar] = {}
_lock = threading.Lock()


def pvar(name: str, klass: int = PVAR_CLASS_COUNTER, desc: str = "") -> PVar:
    """Declare (or fetch) a pvar."""
    with _lock:
        pv = _pvars.get(name)
        if pv is None:
            cls = HistPVar if klass == PVAR_CLASS_HISTOGRAM else PVar
            pv = _pvars[name] = cls(name, klass, desc)
        return pv


pvar("coll_level_chip", PVAR_CLASS_COUNTER,
     "collective calls that exercised the chip level: an on-card slot "
     "fold among co-resident ranks (coll/device.py _run)")
pvar("coll_level_ici", PVAR_CLASS_COUNTER,
     "collective calls that exercised the ring level: the 1:1 mesh "
     "channel's ring kernels or their stock lowering (coll/device.py "
     "_run)")
pvar("dev_coll_tier_vmem", PVAR_CLASS_COUNTER,
     "device collective calls planned on the small-message resident "
     "ring tier (ops/ring.py, K6/K7)")
pvar("dev_coll_tier_hbm", PVAR_CLASS_COUNTER,
     "device collective calls planned on the chunked streaming tier: the "
     "ring (ops/ici.py, K3/K5) or the pairwise alltoall(v) "
     "(ops/alltoall.py, K10/K11)")
pvar("dev_coll_tier_quant", PVAR_CLASS_COUNTER,
     "device collective calls planned on the block-scaled quantized ring "
     "tier (ops/quant.py, K9: the ring's codec chain, gather and decode "
     "in one launch)")
pvar("dev_coll_quant_bytes_saved", PVAR_CLASS_COUNTER,
     "bytes a rank kept off the ring by the quant tier: exact minus "
     "quantized wire bytes of each call (ops/quant.py wire_stats)")
pvar("dev_coll_fallback_size", PVAR_CLASS_COUNTER,
     "device collectives routed to the stock torch lowering because "
     "the shard was at or past DEV_TIER_XLA_MIN (or past the resident "
     "kernels' 4 MiB limit)")
pvar("dev_coll_fallback_dtype", PVAR_CLASS_COUNTER,
     "device collectives routed to the stock torch lowering because "
     "the op or dtype does not lower to the kernels")
pvar("dev_coll_fallback_shape", PVAR_CLASS_COUNTER,
     "device collectives routed to the stock torch lowering because "
     "of a degenerate buffer extent")
for _tier in ("vmem", "hbm", "quant", "xla", "slot"):
    pvar(f"dev_effbw_{_tier}", PVAR_CLASS_HIGHWATERMARK,
         f"best per-call rate (GB/s) on the '{_tier}' device tier: "
         f"payload bytes over the host-clock time of the collective")
pvar("dev_coll_fallback_nbc", PVAR_CLASS_COUNTER,
     "nonblocking collectives on a device-capable comm that could not "
     "route through the device tier (op/dtype/residency/size, the slot "
     "or fold channel) and took the host schedule instead "
     "(coll/device.py build_nonblocking_request)")
pvar("dev_persistent_starts", PVAR_CLASS_COUNTER,
     "persistent-collective start() dispatches that rode the device "
     "nonblocking tier (MPI_*_init handles whose programs were built at "
     "init, core/comm.py _coll_init)")
pvar("dev_nbc_segments", PVAR_CLASS_COUNTER,
     "device nonblocking-collective program segments launched by the NBC "
     "DAG's poll vertices (coll/device.py _nb_poll: each launch enqueues "
     "the segment's kernels on the rendezvous's side stream, which the "
     "engine then polls to completion)")
pvar("dev_rma_tier_rdma", PVAR_CLASS_COUNTER,
     "one-sided window ops served by the chunked kernels (ops/rma.py "
     "put/get/accumulate, K12-K14)")
pvar("dev_rma_tier_quant", PVAR_CLASS_COUNTER,
     "one-sided f32 accumulates served by K14's quantized wire (ops/rma.py "
     "rma_accumulate(quantized=True), K9's codec)")
pvar("dev_rma_tier_epoch", PVAR_CLASS_COUNTER,
     "one-sided window ops served by the epoch tier (stock torch "
     "indexing on the window rows, rma/device.py)")
pvar("dev_rma_fallback_noncontig", PVAR_CLASS_COUNTER,
     "one-sided ops routed to the epoch tier because the element "
     "pattern is strided")
pvar("dev_rma_fallback_platform", PVAR_CLASS_COUNTER,
     "one-sided ops routed to the epoch tier because the kernels cannot "
     "run here (the port plans the kernel tier everywhere: stays 0)")
pvar("dev_rma_fallback_size", PVAR_CLASS_COUNTER,
     "one-sided ops routed to the epoch tier because the payload is "
     "below DEV_RMA_RDMA_MIN (or empty)")
pvar("dev_rma_fallback_dtype", PVAR_CLASS_COUNTER,
     "one-sided ops routed to the epoch tier because the window dtype "
     "does not lower to the kernels (bool, complex)")
pvar("dev_rma_flush", PVAR_CLASS_COUNTER,
     "passive-target completion waves (flush/flush_local/unlock) closed "
     "on a DeviceWin")
pvar("dev_rma_wire_bytes", PVAR_CLASS_COUNTER,
     "bytes the kernel tiers of the one-sided windows put on the wire: "
     "the payload, or a quantized accumulate's wire words")

# the latency histograms the ported paths record, as the JAX package
# declares them (mpit.py's telemetry block)
HISTOGRAMS = {
    "lat_dev_vmem": "device collective latency on the resident ring tier "
                    "(coll/device.py _run end-to-end)",
    "lat_dev_hbm": "device collective latency on the HBM ring tier "
                   "(coll/device.py _run end-to-end)",
    "lat_dev_quant": "device collective latency on the block-scaled "
                     "quantized tier (coll/device.py _run end-to-end)",
    "lat_dev_xla": "device collective latency on the stock torch lowering "
                   "(coll/device.py _run end-to-end)",
    "lat_dev_slot": "device collective latency on the slot tier "
                    "(coll/device.py _run end-to-end)",
    "lat_dev_nbc": "device nonblocking-collective segment latency "
                   "(coll/device.py _nb_poll: launch to observed "
                   "completion on the NBC DAG)",
    "lat_rma_flush": "one-sided completion-wave latency (rma/device.py "
                     "fence/flush/unlock around the queued-op drain)",
    "lat_coll_sched": "host collective schedule latency (coll/api.py "
                      "bcast and allreduce around the algorithm)",
}
for _name, _desc in HISTOGRAMS.items():
    pvar(_name, PVAR_CLASS_HISTOGRAM,
         f"log2-bucketed latency histogram (us): {_desc}")
