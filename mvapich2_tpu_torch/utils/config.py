"""Control variables the port reads (a trimmed copy of the JAX package's
``utils/config.py`` registry, with the defaults its ``mpit.py`` and
``coll/tuning.py`` declare).

* ``USE_DEVICE_COLL``, the per-collective ``<COLL>_ALGO`` overrides and
  the host-to-device crossover ``DEVICE_COLL_MIN_BYTES``, read by
  ``coll/device.py`` ``_select_transport``;
* the ring engine's knobs ``ICI_CHUNK_BYTES``, ``ICI_PIPELINE_DEPTH`` and
  ``ICI_BIDIR`` (``ops/ici.py``);
* the device tier edges ``DEV_TIER_VMEM_MAX``, ``DEV_TIER_XLA_MIN`` and
  ``DEV_TIER_QUANT_MIN`` (-1 = never), the multi-axis mesh edge
  ``DEV_TIER_AXES_MIN`` (-1 = always decompose), and the quant budget
  ``QUANT_COLL`` (``coll/tuning.py`` ``device_tier``); ``QUANT_BLOCK``,
  the quantization block in bytes (``ops/quant.py``);
* the one-sided knobs ``RMA_CHUNK_BYTES`` (0 inherits
  ``ICI_CHUNK_BYTES``), the tier edges ``DEV_RMA_RDMA_MIN`` and
  ``DEV_RMA_QUANT_MIN`` (``ops/rma.py`` ``planned_rma_tier``);
* the segmentation of the nonblocking device collectives,
  ``DEVICE_NBC_SEG_BYTES`` and ``DEVICE_NBC_MAX_SEGS`` (``coll/device.py``
  ``_nb_segments``);
* the observability switches ``TRACE``, ``TRACE_BUF`` and ``TRACE_DIR``
  (the per-rank event recorder, ``trace/recorder.py``), ``METRICS`` (the
  latency histograms, ``metrics/__init__.py``) and ``JAX_PROFILE`` (a
  directory for the ``torch.profiler`` bracket of ``coll/device.py``;
  the JAX package's name is kept).

Each is settable through the same ``MV2T_<NAME>`` environment variable
as in the JAX package, read at first use (``reload`` reads them again),
or with :meth:`Config.set`.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

ENV_PREFIX = "MV2T_"

_TRUE = {"1", "true", "yes", "on", "y"}
_FALSE = {"0", "false", "no", "off", "n"}


def _parse(typ: type, raw: str) -> Any:
    if typ is bool:
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"bad boolean: {raw!r}")
    if typ is int:
        # size suffixes 64K / 2M / 1G, as in the JAX package
        s = raw.strip().upper()
        mult = 1
        if s and s[-1] in "KMG":
            mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}[s[-1]]
            s = s[:-1]
        return int(s) * mult
    return raw.strip()


class Config:
    """Registry of the port's cvars: name -> (default, type), values read
    from the environment at first use and overridable with ``set``."""

    def __init__(self, decls: Dict[str, Any]) -> None:
        self._defaults = dict(decls)
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _load(self, name: str) -> Any:
        default = self._defaults[name]
        raw = os.environ.get(ENV_PREFIX + name)
        return default if raw is None else _parse(type(default), raw)

    def __getitem__(self, name: str) -> Any:
        with self._lock:
            if name not in self._values:
                self._values[name] = self._load(name)
            return self._values[name]

    def get(self, name: str, default: Any = None) -> Any:
        if name not in self._defaults:
            return default
        return self[name]

    def set(self, name: str, value: Any) -> None:
        if name not in self._defaults:
            raise KeyError(f"unknown cvar {name!r}")
        with self._lock:
            self._values[name] = value

    def reload(self) -> None:
        """Forget every value read or set: the next read takes the
        environment again."""
        with self._lock:
            self._values.clear()


# <COLL>_ALGO names, one per MPI collective family the device channels run
ALGO_CVARS = ("ALLREDUCE", "REDUCE", "BCAST", "ALLGATHER", "ALLTOALL",
              "REDUCE_SCATTER")

# the ring engine, the device tier edges and the one-sided knobs, with
# the JAX package's defaults (mpit.py ICI_*, RMA_CHUNK_BYTES and
# QUANT_BLOCK; coll/tuning.py DEV_TIER_* and DEV_RMA_*; coll/device.py
# DEVICE_COLL_MIN_BYTES and DEVICE_NBC_*)
DEVICE_CVARS = {
    "DEVICE_COLL_MIN_BYTES": 16384,
    "ICI_CHUNK_BYTES": 256 * 1024,
    "ICI_PIPELINE_DEPTH": 2,
    "ICI_BIDIR": True,
    "DEV_TIER_VMEM_MAX": 4 * 1024 * 1024,
    "DEV_TIER_XLA_MIN": -1,
    "DEV_TIER_QUANT_MIN": 1024 * 1024,
    "DEV_TIER_AXES_MIN": 4096,
    "QUANT_COLL": "",
    "RMA_CHUNK_BYTES": 0,
    "DEV_RMA_RDMA_MIN": 0,
    "DEV_RMA_QUANT_MIN": 1024 * 1024,
    "QUANT_BLOCK": 512,
    # the nonblocking device collectives' segments (coll/device.py
    # DeviceCollChannel._nb_segments): bytes a shard a segment (0 = one
    # segment) and at most this many segments a call
    "DEVICE_NBC_SEG_BYTES": 1 << 20,
    "DEVICE_NBC_MAX_SEGS": 8,
}

# the recorder, histogram and profiler switches, with the JAX package's
# defaults (trace/recorder.py TRACE*, mpit.py METRICS and JAX_PROFILE)
TRACE_CVARS = {
    "TRACE": False,
    "TRACE_BUF": 65536,
    "TRACE_DIR": "",
    "METRICS": 1,
    "JAX_PROFILE": "",
}

_config = Config({"USE_DEVICE_COLL": True,
                  **{f"{c}_ALGO": "" for c in ALGO_CVARS},
                  **DEVICE_CVARS, **TRACE_CVARS})


def get_config() -> Config:
    return _config
