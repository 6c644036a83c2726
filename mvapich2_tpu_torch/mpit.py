"""Performance variables the port's slot path bumps (a minimal copy of
the JAX package's ``mpit.py`` pvar registry, under the same names):

* ``coll_level_chip`` - counter: collective calls that ran an on-card
  slot fold among co-resident ranks;
* ``dev_effbw_slot`` - high-watermark: the best per-call rate (GB/s) of
  the slot channel, payload bytes over the host-clock time of the
  collective.
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
pvar("dev_effbw_slot", PVAR_CLASS_HIGHWATERMARK,
     "best per-call rate (GB/s) of the slot channel: payload bytes over "
     "the host-clock time of the collective")
