"""Process mode: build this rank's Universe from the environment (a
trimmed copy of the JAX package's ``runtime/bootstrap.py``).

``bootstrap_from_env`` is the second half of ``mpi.Init`` under
``mpirun``: after the light boot (``runtime/boot.py``: the KVS fence of
node topology and the leader's segment files), ``build_world``
constructs the Universe with a TCP channel as the default route to
every peer and, where the node holds more ranks than this one, one
shared-memory channel to them (``_wire_channels``), initializes
COMM_WORLD and COMM_SELF (and, under MV2T_TRACE, the rank's recorder,
whose ring Finalize writes to MV2T_TRACE_DIR) and publishes this rank's
``__built-<rank>`` card, which the Finalize rendezvous reads. Without ``MV2T_KVS`` (a
program started without ``mpirun``) the rank is a singleton: a world of
one on the in-process fabric. The JAX package's spawned-children path
waits with ``MPI_Comm_spawn``.

A process-mode rank binds no device channel: its COMM_WORLD runs the
host tier, and a tensor on the card given to one of its collectives
raises ``NotImplementedError`` (``core/comm.py`` ``_stage_if_unbound``),
as the JAX package's rank processes run the host runtime only.
"""

from __future__ import annotations

import logging

import torch

from .. import metrics, trace
from ..utils import timestamps as ts
from ..utils.config import get_config
from . import boot as bootmod
from .universe import Universe

log = logging.getLogger("mvapich2_tpu_torch.runtime.bootstrap")

# process-mode ranks run the host tier: their universes name the CPU
HOST = torch.device("cpu")


def bootstrap_from_env() -> Universe:
    with ts.phase("light boot"):
        boot = bootmod.current_boot() or bootmod.light_boot_from_env()
    if boot is None:
        # singleton init (a program started without mpirun)
        get_config().reload()
        from ..transport.local import LocalChannel, LocalFabric
        u = Universe(0, 1, HOST)
        fabric = LocalFabric(1)
        u.set_default_channel(LocalChannel(fabric, 0))
        fabric.register(0, u.engine)
        _initialize(u)
        return u
    with ts.phase("world build"):
        return build_world(boot)


def _initialize(u: Universe) -> None:
    """COMM_WORLD and COMM_SELF, and the observability a thread rank gets
    from ``local_universe``: the recorder under MV2T_TRACE, the
    latency-histogram gate."""
    u.initialize()
    trace.maybe_attach(u)
    metrics.ensure_live()


def build_world(boot: bootmod.BootState) -> Universe:
    """Phase two of Init: the world build. Publishes this rank's build
    cards and marks it built."""
    u = Universe(boot.rank, boot.size, HOST, boot.node_ids)
    u.node_name_to_id = boot.node_name_to_id
    u.kvs = boot.kvs
    _wire_channels(u, boot.kvs, boot)
    _initialize(u)
    boot.kvs.put(f"__built-{boot.rank}", "1")
    boot.world_built = True
    return u


def _wire_channels(u: Universe, kvs, boot: bootmod.BootState) -> None:
    """The default TCP channel, and the shared-memory channel to the
    co-located ranks over their leader's segment (none when the leader
    provisioned none: the node talks over TCP)."""
    from ..transport.tcp import TcpChannel
    pid = u.world_rank
    u.set_default_channel(TcpChannel(pid, kvs))
    local = [r for r in u.world_ranks if u.node_ids[r] == u.node_ids[pid]]
    if len(local) < 2:
        return
    card = bootmod.leader_seg_card(boot)
    if card is None:
        return
    from ..transport.shm import ShmChannel
    try:
        shm = ShmChannel(pid, local, kvs, card)
    except OSError as e:
        log.warning("shm channel unavailable (%s); using tcp intra-node", e)
        return
    for r in local:
        if r != pid:
            u.set_channel(r, shm)
    u.shm_channel = shm
