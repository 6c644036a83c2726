"""The large-message host tiers of the tuning tables (a trimmed copy of
the JAX package's ``coll/shmcoll.py``): the branches an in-process
universe takes when no shared collective segment or arena exists.

``allreduce_rsa_arena`` (the tables' top allreduce bin) runs
``allreduce_two_level_slotted``, which runs ``alg.allreduce_two_level``
with Rabenseifner between the leaders (Rabenseifner over the whole comm
when it lies on one node); ``bcast_arena`` runs
``bcast_scatter_ring_allgather``. The JAX package's thread ranks build a
slotted segment in ``/dev/shm`` and take its sectioned reduce-scatter
and allgather there instead (``USE_ARENA_COLL`` and
``USE_SLOTTED_SHM_COLL`` off make it take these branches too): the
segment, the arena and CMA wait with the process-mode transports. Both
fold every element once per rank, so integer data and integer-valued
floats give the same bits either way.
"""

from __future__ import annotations

import numpy as np

from . import algorithms as alg


def allreduce_two_level_slotted(comm, arr: np.ndarray, op, tag: int,
                                inter_algo=None) -> np.ndarray:
    """Two-level allreduce (the slotted segment's intra-node phases are
    not ported: the point-to-point two-level runs)."""
    inter = inter_algo or alg.allreduce_recursive_doubling
    shmem, leader = comm.build_2level()
    if shmem is None or shmem.size < 2:
        return inter(comm, arr, op, tag)
    return alg.allreduce_two_level(comm, arr, op, tag, inter)


def allreduce_rsa_arena(comm, arr: np.ndarray, op, tag: int,
                        inter_algo=None) -> np.ndarray:
    """Large-message allreduce tier: the two-level path with Rabenseifner
    between the leaders."""
    inter = inter_algo or alg.allreduce_reduce_scatter_allgather
    return allreduce_two_level_slotted(comm, arr, op, tag, inter)


def bcast_arena(comm, data: np.ndarray, root: int, tag: int) -> None:
    """Large-message bcast tier: scatter + ring allgather."""
    return alg.bcast_scatter_ring_allgather(comm, data, root, tag)
