"""Control variables the port reads (a trimmed copy of the JAX package's
``utils/config.py`` registry, with the defaults its ``mpit.py`` and
``coll/tuning.py`` declare).

* ``USE_DEVICE_COLL``, the per-collective ``<COLL>_ALGO`` overrides and
  the host-to-device crossover ``DEVICE_COLL_MIN_BYTES``, read by
  ``coll/device.py`` ``_select_transport``; the overrides also pick the
  host algorithm (``coll/tuning.py`` ``select_algorithm``), beside
  ``USE_TWO_LEVEL`` (the node-aware allreduce);
* the point-to-point protocol's ``EAGER_THRESHOLD`` (64 KiB, to a rank
  of another node), ``SMP_EAGERSIZE`` (32 KiB, to a rank of the same
  node; also the "eager" edge of the host tuning tables),
  ``RNDV_PROTOCOL`` (RGET, RPUT or R3) and ``R3_CHUNK_SIZE``
  (``pt2pt/protocol.py``);
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
* process mode (``mpirun``): ``STARTUP_TIMING``, the ``mpi.Init``
  phase timestamps (``utils/timestamps.py``); the shared-memory
  rendezvous's rungs: ``USE_CMA`` (``transport/shm.py``),
  ``ARENA_BYTES``, ``RNDV_CHUNK`` and ``RNDV_DEPTH``
  (``transport/arena.py``, ``pt2pt/protocol.py``);
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


# <COLL>_ALGO names, one per MPI collective family with a choice of
# algorithm (the JAX package's coll/tuning.py cvars)
ALGO_CVARS = ("ALLREDUCE", "REDUCE", "BCAST", "ALLGATHER", "ALLTOALL",
              "REDUCE_SCATTER", "BARRIER")

# the host tier's protocol edges, with the JAX package's defaults
# (utils/config.py and pt2pt/protocol.py)
HOST_CVARS = {
    "EAGER_THRESHOLD": 64 * 1024,
    "SMP_EAGERSIZE": 32 * 1024,
    "RNDV_PROTOCOL": "RGET",
    "R3_CHUNK_SIZE": 1 << 18,
    "USE_TWO_LEVEL": True,
}

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

# process mode, with the JAX package's defaults (utils/timestamps.py;
# transport/shm.py USE_CMA; transport/arena.py ARENA_BYTES, RNDV_CHUNK
# and RNDV_DEPTH)
PROCESS_CVARS = {
    "STARTUP_TIMING": False,
    # cross-memory attach for a shared-memory rendezvous, where every
    # co-located rank's probe agrees (0: the arena, then the file)
    "USE_CMA": 1,
    # a rank's partition of the node's scratch arena (0: 256 MiB for 2
    # co-located ranks, 128 MiB for 3-4, 32 MiB beyond)
    "ARENA_BYTES": 0,
    # the pipelined arena rendezvous's chunk (also the CMA read's step)
    # and its least depth in chunks. The depth taken is the larger of
    # RNDV_DEPTH and a sixteenth of the partition in chunks: 8 or more at
    # every automatic partition with the default chunk, so RNDV_DEPTH
    # binds only under a small ARENA_BYTES or a large RNDV_CHUNK
    "RNDV_CHUNK": 256 * 1024,
    "RNDV_DEPTH": 4,
}

_config = Config({"USE_DEVICE_COLL": True,
                  **{f"{c}_ALGO": "" for c in ALGO_CVARS},
                  **HOST_CVARS, **DEVICE_CVARS, **TRACE_CVARS,
                  **PROCESS_CVARS})


def get_config() -> Config:
    return _config
