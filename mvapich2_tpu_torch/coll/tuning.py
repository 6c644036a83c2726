"""Kernel parameters and the device tier edges of the port (counterpart
of ``mvapich2_tpu/coll/tuning.py`` ``kernel_param`` and ``device_tier``).

Only compiled-in defaults and cvars: the port loads no tuning profile,
because the JAX package's ``profiles/*.json`` were measured on a TPU or
under the CPU interpreter and say nothing about a GPU. So every edge
resolves as the JAX package's does with no profile loaded: the cvar's
value, whether set explicitly or left at its default.
"""

from __future__ import annotations

from ..utils.config import get_config

# CUDA launch shape of the kernels: threads per block of the slot
# kernels (ops/hbm.py) and blocks per SM (their grid is a multiple of the
# SM count); threads per block of the ring kernels (ops/ring.py,
# ops/ici.py) and blocks per SM spread over their lanes. The ring values
# come from the launch-shape sweep of ``chip_smoke.py --sweep`` on an
# H100 (PERF.md).
_KERNEL_PARAMS = {
    "hbm_slot_threads": 256,
    "hbm_slot_blocks_per_sm": 8,
    "ring_threads": 1024,
    "ring_blocks_per_sm": 1,
}

# the JAX package's default DEV_TIER_QUANT_MIN: the smallest shard the
# quant bin takes (a cvar again once its kernel, K9, is ported)
_QUANT_MIN = 1024 * 1024


def kernel_param(key: str, default: int) -> int:
    """The compiled-in kernel parameter ``key``, or ``default`` when the
    table has no entry for it."""
    return _KERNEL_PARAMS.get(key, default)


def set_kernel_param(key: str, value: int) -> None:
    """Override kernel parameter ``key`` for this process (the launch-shape
    sweep sets each shape it times through this)."""
    _KERNEL_PARAMS[key] = int(value)


def _quant_budget() -> float:
    """The relative-error budget MV2T_QUANT_COLL carries: ``''`` = off,
    ``'<budget>'`` or ``'<wire>:<budget>'`` with wire q8 or fp8. A
    malformed value reads as off, as in the JAX package."""
    raw = str(get_config()["QUANT_COLL"] or "").strip()
    wire, _, budget = raw.rpartition(":")
    if wire.strip().lower() not in ("", "q8", "fp8"):
        return 0.0
    try:
        return max(0.0, float(budget))
    except ValueError:
        return 0.0


def device_tier(name: str, shard_nbytes: int) -> str:
    """'vmem' | 'hbm' | 'quant' | 'xla' for a device collective shard of
    ``shard_nbytes``: at or below DEV_TIER_VMEM_MAX the resident ring
    (K6/K7), then the quant bin when MV2T_QUANT_COLL carries a budget
    and the shard is at least 1 MiB, then the stock lowering at or above
    DEV_TIER_XLA_MIN (-1 = never), else the chunked streaming ring
    (K3/K5). The names keep the JAX package's tier labels: 'vmem' is the
    small-message tier, 'hbm' the streaming one."""
    cfg = get_config()
    if shard_nbytes <= int(cfg["DEV_TIER_VMEM_MAX"]):
        return "vmem"
    if _quant_budget() > 0 and shard_nbytes >= _QUANT_MIN:
        return "quant"
    xmin = int(cfg["DEV_TIER_XLA_MIN"])
    if xmin >= 0 and shard_nbytes >= xmin:
        return "xla"
    return "hbm"
