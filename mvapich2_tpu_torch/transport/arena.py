"""The per-node scratch arena and the cross-memory-attach reader (a copy
of the JAX package's ``transport/arena.py``, less the node daemon's warm
attach).

One mmap'd file a node, created by the node's leader beside its ring
segment (``transport/shm.py``) and carved into size-classed blocks: the
registration-cache analog of MVAPICH2's dreg.c. A rendezvous send copies
its packed buffer into a block once, the receiver reads the block in
place, and the FIN frees it for the next send; an oversize packet that
does not fit a ring spills into a block instead of a file.

Layout (offsets are file-absolute, so they travel on the wire)::

    spill-consumed grid   n*n u64    the receiver's count of consumed
                                     arena spill notes per (src, dst)
    partition 0           PART bytes owned by local rank 0
    ...
    partition n-1         PART bytes owned by local rank n-1

Each rank allocates only from its own partition (size-classed free
lists, no cross-process lock); any rank may read any offset.

``cma_read`` is the ``process_vm_readv`` reader of the CMA rung (the
path of ch3_smp_progress.c:525): the receiver copies the sender's live
buffer out of the sender's address space.

Cvars (the JAX names and defaults, ``utils/config.py``): ``ARENA_BYTES``
(a rank's partition; 0 = 256 MiB for 2 co-located ranks, 128 MiB for
3-4, 32 MiB beyond), ``RNDV_CHUNK`` (256 KiB, the pipelined rendezvous's
chunk and the CMA read's step) and ``RNDV_DEPTH`` (4, the pipeline's
least depth). Pvars: ``arena_allocs``, ``arena_bytes_hwm``,
``rndv_pipeline_chunks``, ``rndv_cma_bytes`` and
``arena_reclaimed_dead``.
"""

from __future__ import annotations

import ctypes
import logging
import mmap
import os
import re
import threading
from typing import Dict, List, Optional

import numpy as np

from .. import mpit
from ..utils.config import get_config

log = logging.getLogger("mvapich2_tpu_torch.transport.arena")

pv_allocs = mpit.pvar("arena_allocs", mpit.PVAR_CLASS_COUNTER,
                      "blocks allocated from the per-node scratch arena")
pv_hwm = mpit.pvar("arena_bytes_hwm", mpit.PVAR_CLASS_HIGHWATERMARK,
                   "high-watermark of arena bytes in use")
pv_pipeline = mpit.pvar("rndv_pipeline_chunks", mpit.PVAR_CLASS_COUNTER,
                        "chunks moved by the pipelined rendezvous")
pv_cma_bytes = mpit.pvar("rndv_cma_bytes", mpit.PVAR_CLASS_COUNTER,
                         "bytes read via cross-memory attach "
                         "(process_vm_readv)")
pv_reclaimed_dead = mpit.pvar(
    "arena_reclaimed_dead", mpit.PVAR_CLASS_COUNTER,
    "arena blocks and segments reclaimed from dead ranks (the stale "
    "segment sweep)")

_PAGE = 4096


# ---------------------------------------------------------------------------
# cross-memory attach (CMA) read
# ---------------------------------------------------------------------------

class _IoVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p),
                ("iov_len", ctypes.c_size_t)]


_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        lib = ctypes.CDLL(None, use_errno=True)
        lib.process_vm_readv.restype = ctypes.c_ssize_t
        lib.process_vm_readv.argtypes = [
            ctypes.c_int, ctypes.POINTER(_IoVec), ctypes.c_ulong,
            ctypes.POINTER(_IoVec), ctypes.c_ulong, ctypes.c_ulong]
        _libc = lib
    return _libc


def cma_probe(pid: int, addr: int, n: int) -> bytes:
    """``n`` bytes at ``addr`` of process ``pid`` (b"" when the read
    fails): the wiring's CMA probe, which counts nothing."""
    buf = ctypes.create_string_buffer(n)
    try:
        got = _get_libc().process_vm_readv(
            pid, ctypes.byref(_IoVec(ctypes.addressof(buf), n)), 1,
            ctypes.byref(_IoVec(addr, n)), 1, 0)
    except (OSError, AttributeError):
        return b""
    return buf.raw[:n] if got == n else b""


def cma_read(pid: int, addr: int, out: np.ndarray, chunk: int = 0,
             tracer=None) -> None:
    """Read ``out.nbytes`` bytes at ``addr`` of process ``pid`` into
    ``out`` with process_vm_readv, ``chunk`` bytes a call (0: one call).
    Counts rndv_cma_bytes; under MV2T_TRACE one ``rndv_chunk`` instant a
    chunk."""
    lib = _get_libc()
    total = out.nbytes
    if total == 0:
        return
    step = chunk if chunk and chunk < total else total
    base = out.ctypes.data
    off = 0
    while off < total:
        n = min(step, total - off)
        liov = _IoVec(base + off, n)
        riov = _IoVec(addr + off, n)
        got = lib.process_vm_readv(pid, ctypes.byref(liov), 1,
                                   ctypes.byref(riov), 1, 0)
        if got != n:
            raise OSError(ctypes.get_errno(),
                          f"process_vm_readv({pid}) read {got}/{n}")
        if tracer is not None:
            tracer.record("protocol", "rndv_chunk", "i", dir="cma",
                          offset=off, bytes=n)
        off += n
    pv_cma_bytes.inc(total)


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------

class ArenaHandle:
    """One allocated block."""

    __slots__ = ("off", "cls", "nbytes")

    def __init__(self, off: int, cls: int, nbytes: int):
        self.off = off
        self.cls = cls          # size-class bytes (a power of 2 >= nbytes)
        self.nbytes = nbytes

    def __repr__(self):
        return f"ArenaHandle(off={self.off}, cls={self.cls})"


def _auto_part_bytes(n_local: int) -> int:
    if n_local <= 2:
        return 256 << 20
    if n_local <= 4:
        return 128 << 20
    return 32 << 20


class ShmArena:
    """One rank's mapping of the per-node scratch arena."""

    MIN_CLASS = 64 * 1024

    def __init__(self, path: str, n_local: int, my_index: int,
                 part_bytes: Optional[int] = None, create: bool = False):
        """``create``: the leader makes the file (zero-filled by the
        truncate, which is the initialized state)."""
        if part_bytes is None or part_bytes <= 0:
            part_bytes = int(get_config()["ARENA_BYTES"]) \
                or _auto_part_bytes(n_local)
        part_bytes = (part_bytes + _PAGE - 1) & ~(_PAGE - 1)
        hdr = (n_local * n_local * 8 + _PAGE - 1) & ~(_PAGE - 1)
        total = hdr + n_local * part_bytes
        flags = os.O_RDWR
        if create:
            flags |= os.O_CREAT | os.O_EXCL
        self.fd = os.open(path, flags, 0o600)
        if create:
            os.ftruncate(self.fd, total)
        self.mm = mmap.mmap(self.fd, total)
        self.path = path
        self.n_local = n_local
        self.my_index = my_index
        self.part_bytes = part_bytes
        self._buf = np.frombuffer(self.mm, dtype=np.uint8)
        self._spill = self._buf[:n_local * n_local * 8].view(np.uint64)
        self._part_lo = hdr + my_index * part_bytes
        self._part_hi = self._part_lo + part_bytes
        self._brk = self._part_lo
        self._free: Dict[int, List[int]] = {}
        self._lock = threading.Lock()
        self._outstanding = 0
        self._in_use = 0

    # -- the block allocator (owner-local) --------------------------------
    @classmethod
    def _class_of(cls, nbytes: int) -> int:
        c = cls.MIN_CLASS
        while c < nbytes:
            c <<= 1
        return c

    def alloc(self, nbytes: int) -> Optional[ArenaHandle]:
        """A block of at least ``nbytes`` from this rank's partition, or
        None when the partition is exhausted (the caller takes the file
        rung; never blocks)."""
        if nbytes <= 0:
            nbytes = 1
        c = self._class_of(nbytes)
        if c > self.part_bytes:
            return None
        with self._lock:
            fl = self._free.get(c)
            if fl:
                off = fl.pop()
            elif self._brk + c <= self._part_hi:
                off = self._brk
                self._brk += c
            else:
                return None
            self._outstanding += 1
            self._in_use += c
            pv_allocs.inc()
            pv_hwm.mark(self._in_use)
            return ArenaHandle(off, c, nbytes)

    def free(self, h: ArenaHandle) -> None:
        with self._lock:
            self._free.setdefault(h.cls, []).append(h.off)
            self._outstanding -= 1
            self._in_use -= h.cls

    def view(self, off: int, nbytes: int) -> np.ndarray:
        """A uint8 view of the shared mapping (any rank's partition)."""
        return self._buf[off:off + nbytes]

    @property
    def outstanding(self) -> int:
        """Live blocks (the leak check at close)."""
        with self._lock:
            return self._outstanding

    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._in_use

    # -- spill-consumed counters (oversize packets staged here) -----------
    def spill_consumed(self, src_i: int, dst_i: int) -> int:
        return int(self._spill[src_i * self.n_local + dst_i])

    def bump_spill(self, src_i: int, dst_i: int) -> None:
        # one writer a cell (only dst bumps for src): a plain add
        self._spill[src_i * self.n_local + dst_i] += 1

    # -- lifecycle ----------------------------------------------------------
    def close(self, unlink: bool = False) -> None:
        try:
            self._buf = None
            self._spill = None
            self.mm.close()
        except (BufferError, ValueError):
            pass   # views still alive: the mapping goes with them
        try:
            os.close(self.fd)
        except OSError:
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    @staticmethod
    def sweep_stale(dir_: str) -> int:
        """Unlink the arena and ring files (``mv2t-arena-<pid>-*``,
        ``mv2t-shm-<pid>-*``) in ``dir_`` whose creating process is gone;
        returns the count. Every job's files match, so the port's channel
        never runs it on the shared directory: a job's own files are
        removed by its launcher (``runtime/launcher.sweep_segments``)."""
        n = 0
        try:
            names = os.listdir(dir_)
        except OSError:
            return 0
        for name in names:
            m = re.match(r"mv2t-(?:arena|shm)-(\d+)-", name)
            if not m:
                continue
            try:
                os.kill(int(m.group(1)), 0)
                continue             # its creator lives
            except ProcessLookupError:
                pass
            except OSError:
                continue             # alive, not ours
            try:
                os.unlink(os.path.join(dir_, name))
                n += 1
            except OSError:
                pass
        if n:
            pv_reclaimed_dead.inc(n)
            log.info("swept %d stale arena segment(s) from %s", n, dir_)
        return n
