"""mvapich2_tpu_torch: the PyTorch/CUDA port of mvapich2_tpu's device
collectives.

MPI ranks run as threads of one process (``run_ranks``) on one GPU:
either sharing it through an on-card slot segment whose reduction is a
CUDA kernel written for Hopper (``ops/hbm.py``, ``csrc/hbm_slot.cu``), or
bound one to one to ``p`` virtual devices of a mesh (``make_mesh``),
whose collectives run hand-written ring kernels (``ops/ring.py``,
``ops/ici.py``, ``csrc/ring.cu``). The JAX package ``mvapich2_tpu`` is
the reference this package is tested against; nothing here imports it
or JAX.
"""

from .parallel.mesh import make_mesh
from .runtime.universe import local_universe, run_ranks

__all__ = ["run_ranks", "local_universe", "make_mesh"]
