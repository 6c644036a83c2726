"""mvapich2_tpu_torch: the PyTorch/CUDA port of mvapich2_tpu's device
collectives.

MPI ranks run as threads of one process (``run_ranks``) on one GPU:
either sharing it through an on-card slot segment whose reduction is a
CUDA kernel written for Hopper (``ops/hbm.py``, ``csrc/hbm_slot.cu``), or
bound one to one to ``p`` virtual devices of a mesh (``make_mesh``),
whose collectives run hand-written ring and alltoall(v) kernels
(``ops/ring.py``, ``ops/ici.py``, ``ops/alltoall.py``,
``csrc/ring.cu``). ``bench/moe.py`` drives alltoallv as an MoE step
does. One-sided device windows (``rma.DeviceWin``) put, get and
accumulate through the RMA kernels of ``ops/rma.py`` (also in
``csrc/ring.cu``); ``bench/osu_rma.py`` drives them with the OSU
one-sided band. Under the device channels each rank has the JAX
package's host tier, ported: point-to-point over an in-process fabric
(``pt2pt/``, ``transport/``), the host collective algorithms and their
tuned selection (``coll/api.py``, ``coll/algorithms.py``,
``coll/tuning.py``) and the host NBC schedule
(``coll/nonblocking.py``), which run whatever the JAX package routes to
its host tier. ``graft_entry.py`` is the analog of the JAX package's
``__graft_entry__.py`` entry points.

A program runs the way MPI users run one, too: ``mpi.Init()`` and
``mpi.COMM_WORLD`` (``mpi.py``) under ``python -m
mvapich2_tpu_torch.run -np N python prog.py`` (``runtime/launcher.py``),
one process a rank over the KVS bootstrap and the TCP and
shared-memory channels (``runtime/``, ``transport/``; the host tier),
or ``--vpod``, rank threads bound one to one to a mesh of virtual ranks
on the card (the device channel and its kernels).

The JAX package ``mvapich2_tpu`` is the reference this package is
tested against; nothing here imports it or JAX. Importing the package
imports no torch (the process launcher runs without it); ``run_ranks``,
``local_universe`` and ``make_mesh`` load their modules at first use.
"""

__all__ = ["run_ranks", "local_universe", "make_mesh"]


def __getattr__(name: str):
    if name in ("run_ranks", "local_universe"):
        from .runtime import universe
        return getattr(universe, name)
    if name == "make_mesh":
        from .parallel.mesh import make_mesh
        return make_mesh
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
