"""Kernel parameters of the port (counterpart of
``mvapich2_tpu/coll/tuning.py`` ``kernel_param``).

Only compiled-in defaults: the port loads no tuning profile, because the
JAX package's ``profiles/*.json`` were measured on a TPU or under the CPU
interpreter and say nothing about a GPU.
"""

from __future__ import annotations

# CUDA launch shape of the slot kernels (ops/hbm.py): threads per block,
# and blocks per SM (the grid is a multiple of the SM count).
_KERNEL_PARAMS = {
    "hbm_slot_threads": 256,
    "hbm_slot_blocks_per_sm": 8,
}


def kernel_param(key: str, default: int) -> int:
    """The compiled-in kernel parameter ``key``, or ``default`` when the
    table has no entry for it."""
    return _KERNEL_PARAMS.get(key, default)
