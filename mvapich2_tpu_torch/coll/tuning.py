"""Collective algorithm selection, kernel parameters and the device tier
edges of the port (counterpart of ``mvapich2_tpu/coll/tuning.py``).

Selection order, as in the JAX package:
  1. MV2T_<COLL>_ALGO ("device" forces the device channel, coll/device.py
     ``_select_transport``; a name of ``ALGOS`` forces that host
     algorithm),
  2. the device channel when the comm is bound to one and the call
     lowers (``install_device_coll``'s wrappers over these entries),
  3. the two-level allreduce when the comm spans nodes (``nodes=``),
  4. the message-size bin of ``DEFAULT_TABLES`` by comm-size class.

Only compiled-in tables and cvars: the port loads no tuning profile,
because the JAX package's ``profiles/*.json`` were measured on a TPU or
under the CPU interpreter and say nothing about a GPU. So every edge
resolves as the JAX package's does with no profile loaded: the cvar's
value, whether set explicitly or left at its default. The ``net2``
comm-size class (65 to 256 ranks) raises until the network tier
(``coll/netcoll.py``) is ported, and its algorithms are not in ``ALGOS``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.config import get_config
from . import algorithms as alg
from .shmcoll import (allreduce_rsa_arena, allreduce_two_level_slotted,
                      bcast_arena)

log = logging.getLogger("mvapich2_tpu_torch.coll.tuning")

# ---------------------------------------------------------------------------
# algorithm registries (name -> fn), per collective
# ---------------------------------------------------------------------------

ALGOS: Dict[str, Dict[str, Callable]] = {
    "barrier": {
        "dissemination": alg.barrier_dissemination,
    },
    "bcast": {
        "binomial": alg.bcast_binomial,
        "scatter_ring_allgather": alg.bcast_scatter_ring_allgather,
        "arena": bcast_arena,
    },
    "reduce": {
        "binomial": alg.reduce_binomial,
        "gather_local": alg.reduce_gather_local,
    },
    "allreduce": {
        "rd": alg.allreduce_recursive_doubling,
        "rsa": alg.allreduce_reduce_scatter_allgather,
        "ring": alg.allreduce_ring,
        "two_level": alg.allreduce_two_level,
        "gather_bcast": alg.allreduce_gather_bcast,
        "two_level_slotted": allreduce_two_level_slotted,
        "rsa_arena": allreduce_rsa_arena,
    },
    "allgather": {
        "rd": alg.allgather_recursive_doubling,
        "bruck": alg.allgather_bruck,
        "ring": alg.allgather_ring,
    },
    "alltoall": {
        "bruck": alg.alltoall_bruck,
        "scattered": alg.alltoall_scattered,
        "pairwise": alg.alltoall_pairwise,
    },
}

# ---------------------------------------------------------------------------
# default tables: rows of (msg-size upper bound, algo name) by comm-size
# class; the last row's bound is None (infinity). The symbolic edge
# "eager" is SMP_EAGERSIZE, read at selection time. The JAX package's
# rows, less its "net2" class.
# ---------------------------------------------------------------------------

Table = List[Tuple[Optional[int], str]]

DEFAULT_TABLES: Dict[str, Dict[str, Table]] = {
    "allreduce": {
        "small": [(16 * 1024, "rd"), ("eager", "ring"),
                  (None, "rsa_arena")],
        "flat2": [(8 * 1024, "rd"), ("eager", "rsa"),
                  (None, "rsa_arena")],
        "large": [(8 * 1024, "rd"), ("eager", "rsa"),
                  (None, "rsa_arena")],
    },
    "bcast": {
        "small": [(64 * 1024, "binomial"), (None, "arena")],
        "flat2": [(16 * 1024, "binomial"), (None, "arena")],
        "large": [(16 * 1024, "binomial"), (None, "arena")],
    },
    "allgather": {
        "small": [(32 * 1024, "bruck"), (None, "ring")],
        "flat2": [(8 * 1024, "bruck"), (None, "ring")],
        "large": [(8 * 1024, "bruck"), (None, "ring")],
    },
    "alltoall": {
        "small": [(4 * 1024, "bruck"), (None, "scattered")],
        "flat2": [(1024, "bruck"), (64 * 1024, "scattered"),
                  (None, "pairwise")],
        "large": [(1024, "bruck"), (64 * 1024, "scattered"),
                  (None, "pairwise")],
    },
    "reduce": {
        "small": [(None, "binomial")],
        "flat2": [(None, "binomial")],
        "large": [(None, "binomial")],
    },
    "barrier": {
        "small": [(None, "dissemination")],
        "flat2": [(None, "dissemination")],
        "large": [(None, "dissemination")],
    },
}

# the np ceiling of the JAX package's net2 class (its NET2_MAX_RANKS
# default)
NET2_MAX_RANKS = 256


def _size_class(comm) -> str:
    """small (at most 8 ranks) / flat2 (at most 64) / large (past 256);
    the net2 band between raises: its rows name the network tier."""
    if comm.size <= 8:
        return "small"
    if comm.size <= 64:
        return "flat2"
    if comm.size <= NET2_MAX_RANKS:
        raise NotImplementedError(
            f"a host collective on {comm.size} ranks takes the net2 "
            f"comm-size class, whose leader-bridge tier "
            f"(coll/netcoll.py) is not ported")
    return "large"


def _resolve_edge(bound):
    """A table bin edge: an int, None (infinity) or "eager"
    (SMP_EAGERSIZE)."""
    if bound == "eager":
        return int(get_config()["SMP_EAGERSIZE"])
    return bound


def _lookup(name: str, comm, nbytes: int) -> str:
    rows = DEFAULT_TABLES[name][_size_class(comm)]
    for bound, algo in rows:
        bound = _resolve_edge(bound)
        if bound is None or nbytes <= bound:
            return algo
    return rows[-1][1]


def select_algorithm(comm, name: str, nbytes: int, op=None) -> Callable:
    cfg = get_config()
    # 1. env override
    forced = cfg.get(f"{name.upper()}_ALGO", "")
    if forced:
        fn = ALGOS[name].get(forced)
        if fn is None:
            log.warning("unknown %s algorithm %r; using tuned selection",
                        name, forced)
        else:
            return fn
    # 2. op constraints: non-commutative ops need order-preserving algos
    if op is not None and not op.commutative:
        if name == "allreduce":
            return alg.allreduce_gather_bcast
        if name == "reduce":
            return alg.reduce_gather_local
    # 3. two-level hierarchy when the comm spans nodes
    if (name == "allreduce" and cfg["USE_TWO_LEVEL"]
            and comm.u.num_nodes() > 1 and comm.size > 2
            and _spans_nodes(comm) and nbytes >= 4096):
        return alg.allreduce_two_level
    # 4. tuned table
    return ALGOS[name][_lookup(name, comm, nbytes)]


def _spans_nodes(comm) -> bool:
    nodes = {comm.u.node_ids[comm.world_of(r)] for r in range(comm.size)}
    return len(nodes) > 1


def install_coll_ops(comm) -> None:
    """The comm's collective table (init_MV2_collops analog): its
    methods dispatch through these entries, and a device channel
    overwrites the ones it runs (``coll/device.py``
    ``install_device_coll``)."""
    from . import api
    comm.coll_fns = {
        "barrier": api.barrier,
        "bcast": api.bcast,
        "reduce": api.reduce,
        "allreduce": api.allreduce,
        "allgather": api.allgather,
        "allgatherv": api.allgatherv,
        "gather": api.gather,
        "gatherv": api.gatherv,
        "scatter": api.scatter,
        "scatterv": api.scatterv,
        "alltoall": api.alltoall,
        "alltoallv": api.alltoallv,
        "reduce_scatter_block": api.reduce_scatter_block,
        "reduce_scatter": api.reduce_scatter,
        "scan": api.scan,
        "exscan": api.exscan,
        "_select": lambda name, nbytes, op=None:
            select_algorithm(comm, name, nbytes, op),
    }

# CUDA launch shape of the kernels: threads per block of the slot
# kernels (ops/hbm.py) and blocks per SM (their grid is a multiple of the
# SM count); threads per block of K9 (ops/quant.py, one warp a
# quantization block, at most 512); threads per block of the direct
# RMA kernels (ops/rma.py: the copy of K12/K13, which the fold of K14 and
# K14q share); K8's bulk-copy
# pipeline (ops/ici.py): bytes a tile, shared-memory stages a block,
# tiles loaded ahead of their stores, blocks per SM. The K9, copy and
# K8 values come from the launch-shape sweeps of ``chip_smoke.py
# --sweep`` on an H100 (PERF.md).
_KERNEL_PARAMS = {
    "hbm_slot_threads": 256,
    "hbm_slot_blocks_per_sm": 8,
    "quant_threads": 128,
    "rma_copy_threads": 256,
    "k8_tile_bytes": 32768,
    "k8_stages": 6,
    "k8_ahead": 5,
    "k8_ctas_per_sm": 1,
}


def kernel_param(key: str, default: int) -> int:
    """The compiled-in kernel parameter ``key``, or ``default`` when the
    table has no entry for it."""
    return _KERNEL_PARAMS.get(key, default)


def set_kernel_param(key: str, value: int) -> None:
    """Override kernel parameter ``key`` for this process (the launch-shape
    sweep sets each shape it times through this)."""
    _KERNEL_PARAMS[key] = int(value)


def quant_params() -> Tuple[str, float]:
    """(wire, relative-error budget) that MV2T_QUANT_COLL carries, in
    the JAX package's grammar: ``''`` = off (budget 0), ``'<budget>'``
    (wire q8) or ``'<wire>:<budget>'`` split at the first colon, wire q8
    or fp8. A malformed value reads as off."""
    raw = str(get_config()["QUANT_COLL"] or "").strip()
    if not raw:
        return "q8", 0.0
    wire = "q8"
    if ":" in raw:
        wire, _, raw = raw.partition(":")
        wire = wire.strip().lower()
    try:
        budget = float(raw)
    except ValueError:
        return "q8", 0.0
    if wire not in ("q8", "fp8"):
        return "q8", 0.0
    return wire, max(0.0, budget)


def device_tier(name: str, shard_nbytes: int) -> str:
    """'vmem' | 'hbm' | 'quant' | 'xla' for a device collective shard of
    ``shard_nbytes``: at or below DEV_TIER_VMEM_MAX the resident ring
    (K6/K7); then, when MV2T_QUANT_COLL carries a budget, the quant bin
    (K9) at or above DEV_TIER_QUANT_MIN (-1 = never); then the stock
    lowering at or above DEV_TIER_XLA_MIN (-1 = never); else the chunked
    streaming ring (K3/K5). Whether a call in the quant bin may really
    quantize is ``ops/ici.py`` ``planned_tier``'s check. The names keep
    the JAX package's tier labels: 'vmem' is the small-message tier,
    'hbm' the streaming one."""
    cfg = get_config()
    if shard_nbytes <= int(cfg["DEV_TIER_VMEM_MAX"]):
        return "vmem"
    if quant_params()[1] > 0:
        qmin = int(cfg["DEV_TIER_QUANT_MIN"])
        if qmin >= 0 and shard_nbytes >= qmin:
            return "quant"
    xmin = int(cfg["DEV_TIER_XLA_MIN"])
    if xmin >= 0 and shard_nbytes >= xmin:
        return "xla"
    return "hbm"
