"""mvapich2_tpu_torch: the PyTorch/CUDA port of mvapich2_tpu's device
collectives.

MPI ranks run as threads of one process (``run_ranks``) and share one
GPU; their collectives run through an on-card slot segment whose
reduction is a CUDA kernel written for Hopper (``ops/hbm.py``,
``csrc/hbm_slot.cu``). The JAX package ``mvapich2_tpu`` is the reference
this package is tested against; nothing here imports it or JAX.
"""

from .runtime.universe import local_universe, run_ranks

__all__ = ["run_ranks", "local_universe"]
