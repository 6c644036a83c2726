"""The latency-histogram gate (counterpart of the JAX package's
``metrics/__init__.py`` ``LIVE`` gate; its shm sampler, ring and exporter
belong to the shared-memory transport and are not ported).

Recording sites pay ONE module-attribute check when the histograms are
off::

    mx = metrics.LIVE
    if mx is not None:
        mx.rec_us("lat_dev_slot", us)

``LIVE`` is ``None`` until :func:`ensure_live` runs with ``MV2T_METRICS``
on (the default); ``runtime/universe.py`` ``local_universe`` calls it.
The histograms are the ``mpit.HISTOGRAMS`` pvars.
"""

from __future__ import annotations

import time
from typing import Optional

from .. import mpit
from ..utils.config import get_config

#: The gate: ``None`` = off, a :class:`_Live` once :func:`ensure_live` ran
#: under MV2T_METRICS.
LIVE: Optional["_Live"] = None


class _Live:
    """The histogram pvars, fetched once, and the record helpers the sites
    call: one dict lookup and one ``HistPVar.rec`` a record."""

    __slots__ = ("hists",)

    def __init__(self) -> None:
        self.hists = {n: mpit.pvar(n) for n in mpit.HISTOGRAMS}

    def rec_us(self, name: str, us: float) -> None:
        """Record a latency in microseconds into histogram ``name``
        (unknown names are dropped)."""
        h = self.hists.get(name)
        if h is not None:
            h.rec(int(us))

    def rec_since(self, name: str, t0: float) -> None:
        """Record ``time.perf_counter() - t0`` seconds, in microseconds."""
        h = self.hists.get(name)
        if h is not None:
            h.rec(int((time.perf_counter() - t0) * 1e6))


def ensure_live() -> Optional[_Live]:
    """Arm the gate once (a no-op while MV2T_METRICS is 0)."""
    global LIVE
    if LIVE is None and int(get_config()["METRICS"]) > 0:
        LIVE = _Live()
    return LIVE


def _reset() -> None:
    """Test hook: drop the gate so a re-configured process re-arms."""
    global LIVE
    LIVE = None
