"""Performance variables the port's device channels bump (a minimal copy
of the JAX package's ``mpit.py`` pvar registry, under the same names):

* ``coll_level_chip`` / ``coll_level_ici`` - counters: collective calls
  on the slot channel / on the 1:1 mesh channel;
* ``dev_coll_tier_{vmem,hbm}`` - counters: mesh-channel calls per
  planned ring tier; ``dev_coll_fallback_{size,dtype,shape}`` - calls
  that took the stock torch reduction instead, by reason (the JAX
  package counts its XLA takes the same way; it has no
  ``dev_coll_tier_xla``);
* ``dev_effbw_<tier>`` - high-watermarks: the best per-call rate (GB/s)
  on a tier, payload bytes over the host-clock time of the collective.
"""

from __future__ import annotations

import threading
from typing import Dict

PVAR_CLASS_COUNTER = 0
PVAR_CLASS_HIGHWATERMARK = 3


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


_pvars: Dict[str, PVar] = {}
_lock = threading.Lock()


def pvar(name: str, klass: int = PVAR_CLASS_COUNTER, desc: str = "") -> PVar:
    """Declare (or fetch) a pvar."""
    with _lock:
        pv = _pvars.get(name)
        if pv is None:
            pv = _pvars[name] = PVar(name, klass, desc)
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
     "device collective calls planned on the chunked streaming ring "
     "tier (ops/ici.py, K3/K5)")
pvar("dev_coll_fallback_size", PVAR_CLASS_COUNTER,
     "device collectives routed to the stock torch reduction because "
     "the shard was at or past DEV_TIER_XLA_MIN (or past the resident "
     "kernels' 4 MiB limit)")
pvar("dev_coll_fallback_dtype", PVAR_CLASS_COUNTER,
     "device collectives routed to the stock torch reduction because "
     "the op or dtype does not lower to the ring kernels")
pvar("dev_coll_fallback_shape", PVAR_CLASS_COUNTER,
     "device collectives routed to the stock torch reduction because "
     "of a degenerate buffer extent")
for _tier in ("vmem", "hbm", "xla", "slot"):
    pvar(f"dev_effbw_{_tier}", PVAR_CLASS_HIGHWATERMARK,
         f"best per-call rate (GB/s) on the '{_tier}' device tier: "
         f"payload bytes over the host-clock time of the collective")
