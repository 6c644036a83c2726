"""Kernel parameters and the device tier edges of the port (counterpart
of ``mvapich2_tpu/coll/tuning.py`` ``kernel_param`` and ``device_tier``).

Only compiled-in defaults and cvars: the port loads no tuning profile,
because the JAX package's ``profiles/*.json`` were measured on a TPU or
under the CPU interpreter and say nothing about a GPU. So every edge
resolves as the JAX package's does with no profile loaded: the cvar's
value, whether set explicitly or left at its default.
"""

from __future__ import annotations

from typing import Tuple

from ..utils.config import get_config

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
