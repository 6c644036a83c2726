"""The light boot: the first phase of ``mpi.Init`` in a rank process (a
trimmed copy of the JAX package's ``runtime/boot.py``).

The launcher (``runtime/launcher.py``) exports ``MV2T_RANK``,
``MV2T_SIZE`` and ``MV2T_KVS``. Here a rank connects to the job's KVS
and exchanges its node key (``MV2T_FAKE_NODE``, else the host name) in
ONE fence message, derives the node table from the keys, and, on each
node's leader (the lowest rank of the node, when the node holds more
than one), creates the raw shared-memory segment files: the rings of
every pair of co-located ranks and the flags segment, zero-filled,
which is their initialized state. The leader publishes their paths and
geometry as its ``shm-boot-<rank>`` card, so every rank of the node
attaches without waiting for the leader's world build. The world build
(``runtime/bootstrap.py``) follows inside the same ``Init``.

A spawned child (``MV2T_WORLD_BASE`` set) takes no light boot: its
world comes up in ``runtime/bootstrap.py`` ``_bootstrap_spawned``, and
the lowest child of a node makes the node's segment files there
(``spawned_seg_card``).

``finalize_rendezvous`` and ``close_light`` are the two halves of
``Finalize`` that meet every rank of the job at a KVS fence and drop a
world nobody built. The JAX package's node-daemon warm attach, the
resource-manager rank detection, the failure watcher of ``--ft`` and
the C ABI's deferred build are not ported.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import uuid
from typing import Dict, List, Optional

from .kvs import KVSClient

log = logging.getLogger("mvapich2_tpu_torch.runtime.boot")

# flags-segment layout (the JAX package's transport/shm.py and
# native/shm_layout.h): n_local sleep bytes padded to 8, n_local u64
# lease stamps, then n_local x _FPC_SLOTS u64 counter slots. The port
# reads only the sleep bytes; the rest keeps the file the same size.
_LEASE_ALIGN = 8
_LEASE_STAMP = 8
_FPC_SLOTS = 16


def flags_len(n_local: int) -> int:
    lease_off = (n_local + _LEASE_ALIGN - 1) & ~(_LEASE_ALIGN - 1)
    return lease_off + _LEASE_STAMP * n_local + 8 * _FPC_SLOTS * n_local


def auto_ring_bytes(n_local: int) -> int:
    """The ring of one (src, dst) pair, from the co-located rank count
    alone (the JAX package's default: 4 MiB for 2 ranks, 2 MiB for up to
    4, 1 MiB beyond)."""
    if n_local <= 2:
        return 4 << 20
    if n_local <= 4:
        return 2 << 20
    return 1 << 20


def shm_base_dir() -> str:
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    import tempfile
    return tempfile.gettempdir()


def segment_stem() -> str:
    """A fresh segment path, ``mv2t-shm-<pid>-<8 hex>``: the pid of the
    creating rank lets the launcher sweep what a killed job left
    (``launcher.sweep_segments``)."""
    return os.path.join(shm_base_dir(),
                        f"mv2t-shm-{os.getpid()}-{uuid.uuid4().hex[:8]}")


def write_zeros(fd: int, total: int) -> None:
    """Allocate a segment file's pages, zeroed (not a sparse truncate:
    the ring's hot loop would pay a page fault per 4 KiB until it first
    wraps)."""
    try:
        os.posix_fallocate(fd, 0, total)
        return
    except (AttributeError, OSError):
        pass
    chunk = b"\0" * (1 << 20)
    left = total
    while left > 0:
        n = min(left, len(chunk))
        os.write(fd, chunk if n == len(chunk) else chunk[:n])
        left -= n


class BootState:
    """Everything the world build needs, gathered by the light boot."""

    def __init__(self, rank: int, size: int, kvs: KVSClient):
        self.rank = rank
        self.size = size
        self.kvs = kvs
        self.node_ids: List[int] = []
        self.node_name_to_id: Dict[str, int] = {}
        self.local_ranks: List[int] = []
        self.leader: Optional[int] = None
        # the leader's segment card for my node (None: no shm)
        self.seg_card: Optional[dict] = None
        self.world_built = False
        self.finalized = False


_current: Optional[BootState] = None


def current_boot() -> Optional[BootState]:
    return _current


def _make_raw_segments(n_local: int) -> dict:
    """Leader: create the node's ring and flags files, zero-filled, and
    return their card."""
    ring_bytes = auto_ring_bytes(n_local)
    stem = segment_stem()
    fd = os.open(stem, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        write_zeros(fd, n_local * n_local * ring_bytes)
    finally:
        os.close(fd)
    fpath = stem + ".flags"
    with open(fpath + ".tmp", "wb") as f:
        f.write(b"\0" * flags_len(n_local))
    os.replace(fpath + ".tmp", fpath)   # followers never see a short file
    return {"n_local": n_local, "ring_bytes": ring_bytes, "ring": stem,
            "flags": fpath}


def light_boot_from_env() -> Optional[BootState]:
    """Phase one of ``Init``. None without ``MV2T_KVS`` (a singleton,
    which the caller builds on the in-process fabric). Idempotent."""
    global _current
    if _current is not None:
        return _current
    kvs_addr = os.environ.get("MV2T_KVS")
    if kvs_addr is None or os.environ.get("MV2T_WORLD_BASE") is not None:
        # a singleton, or a spawned child (runtime/bootstrap.py
        # _bootstrap_spawned)
        return None
    rank = int(os.environ.get("MV2T_RANK", "0"))
    size = int(os.environ.get("MV2T_SIZE", "1"))
    # imported here: the launcher imports this module, and the utils
    # package imports torch, which the launcher never pays for
    from ..utils.config import get_config
    get_config().reload()
    kvs = KVSClient(kvs_addr)
    nodekey = os.environ.get("MV2T_FAKE_NODE", socket.gethostname())
    boot = BootState(rank, size, kvs)

    # ONE fence message carries this rank's init-time cards; its release
    # means every rank's cards are readable
    kvs.fence("__boot", cards={f"node-{rank}": nodekey})
    names = kvs.get_many([f"node-{r}" for r in range(size)])
    ids: Dict[str, int] = {}
    boot.node_ids = [ids.setdefault(n, len(ids)) for n in names]
    boot.node_name_to_id = ids
    me = boot.node_ids[rank]
    boot.local_ranks = [r for r in range(size) if boot.node_ids[r] == me]
    boot.leader = boot.local_ranks[0] if len(boot.local_ranks) > 1 else None

    if boot.leader == rank:
        try:
            boot.seg_card = _make_raw_segments(len(boot.local_ranks))
            kvs.put(f"shm-boot-{rank}", json.dumps(boot.seg_card))
        except OSError as e:
            # an empty card: every rank of the node talks over TCP
            log.warning("shm segment provisioning failed (%s); the node "
                        "uses tcp", e)
            kvs.put(f"shm-boot-{rank}", "")
    _current = boot
    return boot


def finalize_rendezvous(boot: BootState) -> bool:
    """Meet every rank of the job at one KVS fence, then say whether any
    rank built a world (its ``__built-<rank>`` card). True: the caller
    takes part in the collective teardown, building its world first if
    it has none."""
    try:
        boot.kvs.fence("__fin")
        vals = boot.kvs.peek_many(
            [f"__built-{r}" for r in range(boot.size)])
        return any(v is not None for v in vals)
    except (OSError, ConnectionError, ValueError):
        # the KVS is gone (an aborting launcher): local knowledge only
        return boot.world_built


def close_light(boot: BootState) -> None:
    """Teardown of a rank whose world was never built: drop the segment
    files this leader provisioned for a world nobody constructed, and
    close the KVS connection."""
    boot.finalized = True
    if boot.seg_card is not None and boot.leader == boot.rank:
        for k in ("ring", "flags"):
            p = boot.seg_card.get(k)
            if p:
                try:
                    os.unlink(p)
                except OSError:
                    pass
    boot.kvs.close()


def leader_seg_card(boot: BootState) -> Optional[dict]:
    """The node leader's segment card, fetched once (followers). None
    when the leader provisioned nothing."""
    if boot.leader is None:
        return None
    if boot.seg_card is not None:
        return boot.seg_card
    raw = boot.kvs.get(f"shm-boot-{boot.leader}")
    if not raw:
        return None
    boot.seg_card = json.loads(raw)
    return boot.seg_card


def spawned_seg_card(kvs: KVSClient, pid: int,
                     local: List[int]) -> Optional[dict]:
    """The segment card of a spawned world's node (``local``: its
    co-located children): the lowest makes the segment files, as a
    light boot's leader does, and publishes ``shm-boot-<pid>``; the
    others read it. None when it could not be made (TCP then)."""
    leader = min(local)
    if pid == leader:
        try:
            card = _make_raw_segments(len(local))
        except OSError as e:
            log.warning("shm segment provisioning failed (%s); the "
                        "spawned node uses tcp", e)
            kvs.put(f"shm-boot-{pid}", "")
            return None
        kvs.put(f"shm-boot-{pid}", json.dumps(card))
        return card
    raw = kvs.get(f"shm-boot-{leader}")
    return json.loads(raw) if raw else None
