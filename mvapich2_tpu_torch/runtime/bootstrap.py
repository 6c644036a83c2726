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
one on the in-process fabric.

A child of ``MPI_Comm_spawn`` (``runtime/spawn.py``; its environment
carries ``MV2T_WORLD_BASE``) skips the light boot and comes up in
``_bootstrap_spawned``: its world is proc ids ``base .. base + n - 1``,
wired over the named KVS fences ``spawn-<base>`` (node cards) and
``spawn-<base>-cards`` (channel cards); the children of one node share
a shared-memory segment that their lowest rank makes (there is no
launcher light boot for them), and talk to the parents over TCP. The
child builds ``MPI_COMM_PARENT`` from the spawn envelope and publishes
``__spawn_ready_<base>`` for the spawn root. The JAX package's failure
watcher (``MV2T_FT``) is not ported.

A process-mode rank binds no device channel: its COMM_WORLD runs the
host tier, and a tensor on the card given to one of its collectives
raises ``NotImplementedError`` (``core/comm.py`` ``_stage_if_unbound``),
as the JAX package's rank processes run the host runtime only.
"""

from __future__ import annotations

import json
import logging
import os
import socket

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
    kvs_addr = os.environ.get("MV2T_KVS")
    if boot is None and kvs_addr and \
            os.environ.get("MV2T_WORLD_BASE") is not None:
        get_config().reload()
        with ts.phase("spawned world build"):
            return _bootstrap_spawned(int(os.environ["MV2T_RANK"]),
                                      int(os.environ["MV2T_SIZE"]),
                                      kvs_addr)
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


def _wire_channels(u: Universe, kvs, boot) -> None:
    """The default TCP channel, and the shared-memory channel to the
    co-located ranks over their leader's segment (none when the leader
    provisioned none: the node talks over TCP). A spawned world has no
    light boot (``boot`` None): its leader makes the segment here."""
    from ..transport.tcp import TcpChannel
    pid = u.world_rank
    u.set_default_channel(TcpChannel(pid, kvs))
    local = [r for r in u.world_ranks if u.node_ids[r] == u.node_ids[pid]]
    if len(local) < 2:
        return
    card = bootmod.leader_seg_card(boot) if boot is not None \
        else bootmod.spawned_seg_card(kvs, pid, local)
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


def _bootstrap_spawned(local: int, size: int, kvs_addr: str) -> Universe:
    """The bootstrap of an MPI_Comm_spawn child: proc id ``base +
    local`` of the job, in a COMM_WORLD of its siblings, its parent
    intercomm built from the spawn envelope in the environment (the
    context id and the parents' proc ids)."""
    from ..core.group import Group
    from ..core.intercomm import Intercomm
    from .kvs import KVSClient

    base = int(os.environ["MV2T_WORLD_BASE"])
    ctx = int(os.environ["MV2T_SPAWN_CTX"])
    parent_ranks = json.loads(os.environ["MV2T_PARENT_RANKS"])
    pid = base + local
    kvs = KVSClient(kvs_addr)
    nodekey = os.environ.get("MV2T_FAKE_NODE", socket.gethostname())
    kvs.fence(group=f"spawn-{base}", count=size,
              cards={f"node-{pid}": nodekey})
    names = kvs.get_many([f"node-{r}" for r in range(base + size)])
    ids: dict = {}
    node_ids = [ids.setdefault(n, len(ids)) for n in names]
    u = Universe(pid, size, HOST, node_ids,
                 world_ranks=range(base, base + size))
    u.node_name_to_id = ids
    u.kvs = kvs
    u.appnum = int(os.environ.get("MV2T_APPNUM", "0"))
    _wire_channels(u, kvs, None)
    kvs.fence(group=f"spawn-{base}-cards", count=size)
    _initialize(u)
    u.claim_context_id(ctx)
    private = u.comm_world.dup()
    u.parent_intercomm = Intercomm(u, private.group, Group(parent_ranks),
                                   ctx, private, name="MPI_COMM_PARENT")
    if local == 0:
        # tell the spawn root that every child's cards are published
        kvs.put(f"__spawn_ready_{base}",
                json.dumps(names[base:base + size]))
    return u
