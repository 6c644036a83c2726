"""MPI_File: MPI-IO semantics over the ADIO layer (a copy of the JAX
package's ``io/file.py``).

File views (``set_view``), independent IO at explicit offsets and at the
individual file pointer (with data sieving for noncontiguous views),
two-phase collective buffering for ``read_at_all``/``write_at_all``
(the aggregate range split into one file domain a rank, then an exchange
over ``coll/algorithms.py`` ``csend``/``crecv``), shared file pointers
(an int64 in a host window on rank 0, ``rma/win.py``, moved by
``fetch_and_op`` under an exclusive lock), ordered-mode collectives,
nonblocking IO on one worker thread a file, sync and atomicity.

Offsets are bytes inside and etypes at the MPI surface (MPI-3.1 §13.3).

Buffers follow the port's host-tier rule: numpy, bytes, or a CPU tensor
read into and written from in place; a tensor on the card raises
``NotImplementedError`` on the calling thread before the file is
touched, never staged to the host.
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..coll.algorithms import crecv, csend
from ..core import op as opmod
from ..core.comm import to_host
from ..core.datatype import BYTE, Datatype, as_bytes_view, from_numpy_dtype
from ..core.errors import (MPIException, MPI_ERR_AMODE, MPI_ERR_ARG,
                           MPI_ERR_FILE, MPI_ERR_READ_ONLY,
                           MPI_ERR_UNSUPPORTED_DATAREP)
from ..core.info import Info
from ..core.request import Request
from ..core.status import Status
from ..rma.win import LOCK_EXCLUSIVE
from ..utils import on_card
from . import adio
from .adio import (MODE_APPEND, MODE_CREATE, MODE_DELETE_ON_CLOSE,
                   MODE_EXCL, MODE_RDONLY, MODE_RDWR, MODE_SEQUENTIAL,
                   MODE_UNIQUE_OPEN, MODE_WRONLY)
from .view import FileView

SEEK_SET, SEEK_CUR, SEEK_END = 600, 602, 604


def _host(buf):
    """A CPU tensor as its numpy view, a tensor on the card refused."""
    if on_card(buf):
        raise NotImplementedError(
            f"MPI-IO has no device path and a tensor on {buf.device} is "
            f"not moved to the host")
    return to_host(buf) if isinstance(buf, torch.Tensor) else buf


def _info_dict(info) -> dict:
    """``info`` (None, a dict or a ``core/info.py`` ``Info``) as a dict."""
    if isinstance(info, Info):
        return dict(info.items())
    return dict(info or {})


def _resolve(buf, count: Optional[int], datatype: Optional[Datatype]):
    """(buf, count, datatype): ``buf`` through :func:`_host`, the count
    and datatype from it where not given."""
    buf = _host(buf)
    if datatype is None:
        if isinstance(buf, np.ndarray):
            datatype = from_numpy_dtype(buf.dtype)
        else:
            datatype = BYTE
    if count is None:
        count = buf.size if isinstance(buf, np.ndarray) \
            else len(buf) // max(datatype.size, 1)
    return buf, count, datatype


class File:
    """An open MPI file (collective over the opening comm)."""

    def __init__(self, comm, filename: str, amode: int, info=None):
        self.comm = comm.dup()            # IO traffic on a private comm
        self.filename = filename
        self.amode = amode
        self.info = _info_dict(info)
        self.atomicity = False
        self.closed = False
        self.fh = adio.open_file(filename, amode)
        self.view = FileView()
        self._pos = 0                     # individual pointer, bytes
        self._lock = threading.Lock()     # pointer + view updates
        self._worker: Optional[threading.Thread] = None   # i-op drain
        self._q: Optional[queue.Queue] = None
        # shared file pointer: an int64 on rank 0, fetch-add via RMA
        self._sp_win = self.comm.win_allocate(8 if self.comm.rank == 0
                                              else 0)
        if self.comm.rank == 0:
            self._sp_win.base[:8] = 0
        if amode & MODE_APPEND:
            # MPI §13.2.1: ALL file pointers start at end of file
            eof = self.view.stream_size_to(self.fh.size())
            self._pos = eof
            if self.comm.rank == 0:
                self._sp_win.base[:8] = np.frombuffer(
                    int(eof).to_bytes(8, "little", signed=True), np.uint8)
        self.comm.barrier()               # open is collective

    # ------------------------------------------------------------------
    def _check(self, writing: bool = False) -> None:
        if self.closed:
            raise MPIException(MPI_ERR_FILE, "file is closed")
        if writing and (self.amode & MODE_RDONLY):
            # ROMIO reports this as the access class, not a bad amode
            raise MPIException(MPI_ERR_READ_ONLY,
                               "write on MODE_RDONLY file")
        if not writing and (self.amode & MODE_WRONLY):
            raise MPIException(MPI_ERR_AMODE, "read on MODE_WRONLY file")

    # -- view ----------------------------------------------------------
    def set_view(self, disp: int = 0, etype: Datatype = BYTE,
                 filetype: Optional[Datatype] = None, datarep: str =
                 "native", info=None) -> None:
        self._check_closed()
        if datarep != "native":
            raise MPIException(MPI_ERR_UNSUPPORTED_DATAREP,
                               f"datarep {datarep!r} unsupported")
        with self._lock:
            self.view = FileView(disp, etype, filetype)
            self._pos = 0

    def get_view(self):
        return (self.view.disp, self.view.etype, self.view.filetype,
                "native")

    def _check_closed(self):
        if self.closed:
            raise MPIException(MPI_ERR_FILE, "file is closed")

    # -- raw run IO (data sieving for noncontiguous views) -------------
    _SIEVE_MAX = 4 << 20

    def _read_runs(self, runs: List[Tuple[int, int]], out: bytearray) -> int:
        """Fill ``out`` from physical runs; data sieving: one big pread
        spanning the runs when the holes are small (ad_read_str.c)."""
        if not runs:
            return 0
        lo, hi = runs[0][0], runs[-1][0] + runs[-1][1]
        total = sum(l for _, l in runs)
        got = 0
        if len(runs) > 1 and hi - lo <= max(self._SIEVE_MAX, total * 2):
            blob = self.fh.read_at(lo, hi - lo)
            pos = 0
            for off, ln in runs:
                piece = blob[off - lo:off - lo + ln]
                out[pos:pos + len(piece)] = piece
                pos += ln           # short file: later runs read as holes
                got += len(piece)
        else:
            pos = 0
            for off, ln in runs:
                piece = self.fh.read_at(off, ln)
                out[pos:pos + len(piece)] = piece
                pos += ln
                got += len(piece)
        return got

    def _write_runs(self, runs: List[Tuple[int, int]], data) -> int:
        """Write ``data`` over physical runs; read-modify-write sieving
        under atomicity, plain per-run writes otherwise."""
        if not runs:
            return 0
        # zero-copy byte view: a payload is not copied twice
        data = as_bytes_view(data)
        if self.atomicity:
            self.fh.lock_all()
        try:
            pos = 0
            for off, ln in runs:
                self.fh.write_at(off, data[pos:pos + ln])
                pos += ln
            return pos
        finally:
            if self.atomicity:
                self.fh.unlock_all()

    # -- independent, explicit offset ----------------------------------
    def read_at(self, offset: int, buf, count: Optional[int] = None,
                datatype: Optional[Datatype] = None,
                view: Optional[FileView] = None) -> Status:
        """``offset`` in etype units (MPI semantics). ``view`` overrides
        the file's current view — nonblocking ops capture the view at
        post time (§13.4.2: a later set_view must not retarget them)."""
        self._check(writing=False)
        v = view if view is not None else self.view
        buf, count, datatype = _resolve(buf, count, datatype)
        nbytes = count * datatype.size
        runs = v.map_range(offset * v.etype.size, nbytes)
        if len(runs) == 1 and datatype.is_contiguous:
            # zero-copy: one physical run straight into the user buffer
            mv = as_bytes_view(buf, writable=True)[:runs[0][1]]
            got = self.fh.read_into(runs[0][0], mv)
            return Status(count=min(got, nbytes))
        out = bytearray(nbytes)
        got = self._read_runs(runs, out)
        datatype.unpack(np.frombuffer(out, np.uint8, count=nbytes),
                        buf, count)
        st = Status(count=min(got, nbytes))
        return st

    def write_at(self, offset: int, buf, count: Optional[int] = None,
                 datatype: Optional[Datatype] = None,
                 view: Optional[FileView] = None) -> Status:
        self._check(writing=True)
        v = view if view is not None else self.view
        buf, count, datatype = _resolve(buf, count, datatype)
        nbytes = count * datatype.size
        if datatype.is_contiguous:
            # zero-copy: the user buffer IS the payload
            payload = as_bytes_view(buf)[:nbytes]
        else:
            payload = np.asarray(datatype.pack(buf, count))
        runs = v.map_range(offset * v.etype.size, nbytes)
        n = self._write_runs(runs, payload)
        return Status(count=n)

    # -- individual file pointer ---------------------------------------
    def _advance(self, nbytes: int, reading: bool = False) -> int:
        """Atomically reserve [pos, pos+nbytes) and return the old pos.

        For reads the advance is clamped to the last whole-etype boundary
        of the view's stream so a short read at EOF leaves the pointer
        after the last etype actually read (MPI-3.1 §13.4.3), not past it
        into a hole — and a drain loop sees count 0 at EOF.
        """
        with self._lock:
            old = self._pos
            new = self._pos + nbytes
            if reading:
                es = max(self.view.etype.size, 1)
                end = self.view.stream_size_to(self.fh.size())
                end -= end % es
                new = min(new, max(end, old))
            self._pos = new
        return old

    def read(self, buf, count: Optional[int] = None,
             datatype: Optional[Datatype] = None) -> Status:
        self._check(writing=False)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._advance(count * datatype.size, reading=True)
        return self.read_at(self._etypes(old), buf, count, datatype)

    def write(self, buf, count: Optional[int] = None,
              datatype: Optional[Datatype] = None) -> Status:
        self._check(writing=True)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._advance(count * datatype.size)
        return self.write_at(self._etypes(old), buf, count, datatype)

    def _etypes(self, nbytes: int) -> int:
        return nbytes // max(self.view.etype.size, 1)

    def seek(self, offset: int, whence: int = SEEK_SET) -> None:
        """``offset`` in etype units."""
        self._check_closed()
        nb = offset * self.view.etype.size
        with self._lock:
            if whence == SEEK_SET:
                new = nb
            elif whence == SEEK_CUR:
                new = self._pos + nb
            elif whence == SEEK_END:
                new = self.view.stream_size_to(self.fh.size()) + nb
            else:
                raise MPIException(MPI_ERR_ARG, f"bad whence {whence}")
            if new < 0:
                raise MPIException(MPI_ERR_ARG, "seek before file start")
            self._pos = new

    def get_position(self) -> int:
        return self._etypes(self._pos)

    def get_byte_offset(self, offset: int) -> int:
        return self.view.physical(offset * self.view.etype.size)

    # -- collective (two-phase) ----------------------------------------
    def read_at_all(self, offset: int, buf, count: Optional[int] = None,
                    datatype: Optional[Datatype] = None,
                    view: Optional[FileView] = None) -> Status:
        return self._coll_io(offset, buf, count, datatype, writing=False,
                             view=view)

    def write_at_all(self, offset: int, buf, count: Optional[int] = None,
                     datatype: Optional[Datatype] = None,
                     view: Optional[FileView] = None) -> Status:
        return self._coll_io(offset, buf, count, datatype, writing=True,
                             view=view)

    def read_all(self, buf, count: Optional[int] = None,
                 datatype: Optional[Datatype] = None) -> Status:
        self._check(writing=False)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._advance(count * datatype.size, reading=True)
        return self.read_at_all(self._etypes(old), buf, count, datatype)

    def write_all(self, buf, count: Optional[int] = None,
                  datatype: Optional[Datatype] = None) -> Status:
        self._check(writing=True)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._advance(count * datatype.size)
        return self.write_at_all(self._etypes(old), buf, count, datatype)

    def _coll_io(self, offset: int, buf, count, datatype,
                 writing: bool,
                 view: Optional[FileView] = None) -> Status:
        """Two-phase collective IO (ad_write_coll.c analog): partition the
        aggregate file range into per-rank file domains; each rank ships
        the run pieces that fall into domain d to aggregator d; aggregators
        do one contiguous (sieved) file access per domain."""
        self._check(writing=writing)
        comm = self.comm
        v = view if view is not None else self.view
        if comm.size == 1:
            # degenerate collective: skip the exchange entirely (matters
            # at bigtype scale — no 2 GiB pickle round-trip to self)
            return (self.write_at(offset, buf, count, datatype, view=v)
                    if writing
                    else self.read_at(offset, buf, count, datatype,
                                      view=v))
        buf, count, datatype = _resolve(buf, count, datatype)
        nbytes = count * datatype.size
        runs = v.map_range(offset * v.etype.size, nbytes)
        data = memoryview(np.asarray(datatype.pack(buf, count)).tobytes()) \
            if writing else None
        # aggregate extent over all ranks (runs are ascending)
        lo = runs[0][0] if runs else (1 << 62)
        hi = runs[-1][0] + runs[-1][1] if runs else 0
        ext = np.zeros(2, np.int64)
        comm.allreduce(np.array([-lo, hi], np.int64), ext, op=opmod.MAX)
        glo, ghi = -int(ext[0]), int(ext[1])
        if ghi <= glo:                       # nobody moves data
            comm.barrier()
            return Status(count=0)
        P = comm.size
        dsz = -(-(ghi - glo) // P)           # file-domain size (ceil)

        # split my runs into per-domain pieces; record the production
        # order so a read can be reassembled into logical-stream order
        per_dest: List[List[Tuple[int, int, bytes]]] = [[] for _ in range(P)]
        emit: List[int] = []                 # domain of the k-th piece
        pos = 0
        for off, ln in runs:
            while ln > 0:
                d = min((off - glo) // dsz, P - 1)
                dom_end = ghi if d == P - 1 else glo + (d + 1) * dsz
                take = min(ln, dom_end - off)
                per_dest[d].append(
                    (off, take, bytes(data[pos:pos + take]) if writing
                     else b""))
                emit.append(d)
                off += take
                ln -= take
                pos += take
        got = self._exchange_and_apply(per_dest, emit, writing, glo, dsz,
                                       ghi)
        if not writing:
            actual = min(len(got), nbytes)
            if len(got) < nbytes:            # short read (EOF holes)
                got = got + b"\0" * (nbytes - len(got))
            datatype.unpack(np.frombuffer(got[:nbytes], np.uint8), buf,
                            count)
            return Status(count=actual)
        return Status(count=nbytes)

    def _exchange_and_apply(self, per_dest, emit, writing: bool, glo: int,
                            dsz: int, ghi: int) -> bytes:
        """The exchange phase: pickled piece lists pairwise; aggregators
        apply writes / serve reads from one sieved access per domain."""
        comm = self.comm
        P = comm.size
        tag = comm.next_coll_tag()

        def a2a_blobs(blobs: List[bytes], t: int) -> List[bytes]:
            lens = np.array([len(b) for b in blobs], np.int64)
            all_lens = np.empty(P, np.int64)
            comm.alltoall(lens, all_lens, count=1)
            rreqs = [(src, np.empty(int(all_lens[src]), np.uint8))
                     for src in range(P)]
            rqs = [crecv(comm, rb, src, t) for src, rb in rreqs]
            sqs = [csend(comm, np.frombuffer(blobs[d], np.uint8), d, t)
                   for d in range(P)]
            for q in rqs + sqs:
                q.wait()
            return [rb.tobytes() for _, rb in rreqs]

        incoming = [pickle.loads(b) for b in a2a_blobs(
            [pickle.dumps(per_dest[d], protocol=4) for d in range(P)], tag)]

        if writing:
            if self.atomicity:
                self.fh.lock_all()
            try:
                for pieces in incoming:
                    for off, ln, payload in pieces:
                        self.fh.write_at(off, payload)
            finally:
                if self.atomicity:
                    self.fh.unlock_all()
            comm.barrier()        # all domains durable before return
            return b""

        # read: one sieved access over my file domain, serve pieces back
        d_lo = glo + comm.rank * dsz
        d_hi = ghi if comm.rank == P - 1 else min(glo + (comm.rank + 1)
                                                  * dsz, ghi)
        dom = self.fh.read_at(d_lo, d_hi - d_lo) if d_hi > d_lo else b""
        replies = []
        for pieces in incoming:
            parts = [bytes(dom[off - d_lo:off - d_lo + ln])
                     for off, ln, _ in pieces]
            replies.append(pickle.dumps(parts, protocol=4))
        by_src = [pickle.loads(b) for b in a2a_blobs(replies, tag + 1)]
        # reassemble in production order: piece k came from domain emit[k]
        out = bytearray()
        next_idx = [0] * P
        for d in emit:
            out.extend(by_src[d][next_idx[d]])
            next_idx[d] += 1
        return bytes(out)

    # -- shared file pointer -------------------------------------------
    def _shared_fetch_add(self, nbytes: int) -> int:
        old = np.zeros(1, np.int64)
        add = np.array([nbytes], np.int64)
        self._sp_win.lock(0, LOCK_EXCLUSIVE)
        self._sp_win.fetch_and_op(add, old, 0, 0, op=opmod.SUM)
        self._sp_win.unlock(0)
        return int(old[0])

    def _shared_advance_read(self, nbytes: int) -> int:
        """Shared-pointer advance clamped to the last whole-etype boundary
        of the stream (EOF): a short read must leave the pointer after the
        last etype read, and a multi-rank drain loop must observe EOF."""
        es = max(self.view.etype.size, 1)
        end = self.view.stream_size_to(self.fh.size())
        end -= end % es
        cur = np.zeros(1, np.int64)
        self._sp_win.lock(0, LOCK_EXCLUSIVE)
        self._sp_win.get(cur, 0, 0)
        self._sp_win.flush(0)
        old = int(cur[0])
        new = min(old + nbytes, max(end, old))
        self._sp_win.put(np.array([new], np.int64), 0, 0)
        self._sp_win.unlock(0)
        return old

    def read_shared(self, buf, count: Optional[int] = None,
                    datatype: Optional[Datatype] = None) -> Status:
        self._check(writing=False)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._shared_advance_read(count * datatype.size)
        return self.read_at(self._etypes(old), buf, count, datatype)

    def write_shared(self, buf, count: Optional[int] = None,
                     datatype: Optional[Datatype] = None) -> Status:
        self._check(writing=True)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._shared_fetch_add(count * datatype.size)
        return self.write_at(self._etypes(old), buf, count, datatype)

    def seek_shared(self, offset: int, whence: int = SEEK_SET) -> None:
        """Collective; all ranks must give the same offset."""
        nb = offset * self.view.etype.size
        if whence == SEEK_CUR or whence == SEEK_END:
            base = self.view.stream_size_to(self.fh.size()) \
                if whence == SEEK_END else self._shared_fetch_add(0)
            nb += base
        if self.comm.rank == 0:
            self._sp_win.lock(0, LOCK_EXCLUSIVE)
            self._sp_win.base[:8] = np.frombuffer(
                int(nb).to_bytes(8, "little", signed=True), np.uint8)
            self._sp_win.unlock(0)
        self.comm.barrier()

    def get_position_shared(self) -> int:
        return self._etypes(self._shared_fetch_add(0))

    # -- ordered mode --------------------------------------------------
    def _ordered_base(self, nbytes: int) -> int:
        sizes = self.comm.allgather(np.array([nbytes], np.int64), count=1)
        total = int(sizes.sum())
        if self.comm.rank == 0:
            base = self._shared_fetch_add(total)
        else:
            base = 0
        b = np.array([base], np.int64)
        self.comm.bcast(b, root=0)
        return int(b[0]) + int(sizes[:self.comm.rank].sum())

    def read_ordered(self, buf, count: Optional[int] = None,
                     datatype: Optional[Datatype] = None) -> Status:
        self._check(writing=False)
        buf, count, datatype = _resolve(buf, count, datatype)
        my = self._ordered_base(count * datatype.size)
        return self.read_at(self._etypes(my), buf, count, datatype)

    def write_ordered(self, buf, count: Optional[int] = None,
                      datatype: Optional[Datatype] = None) -> Status:
        self._check(writing=True)
        buf, count, datatype = _resolve(buf, count, datatype)
        my = self._ordered_base(count * datatype.size)
        return self.write_at(self._etypes(my), buf, count, datatype)

    # -- nonblocking ---------------------------------------------------
    # One worker thread per file drains a FIFO of posted i-ops: every
    # rank posts collective i-ops in the same program order, so the
    # workers across ranks execute matching ops in matching order and
    # two outstanding collectives can never interleave their exchange
    # traffic on the file's dup comm (ROMIO serializes per-file the
    # same way via the ADIOI request queue).
    def _async(self, fn, *a) -> Request:
        req = Request(self.comm.u.engine, "io")
        with self._lock:
            if self._worker is None:
                self._q = queue.Queue()
                self._worker = threading.Thread(
                    target=self._drain, daemon=True, name="mpiio")
                self._worker.start()
        self._q.put((fn, a, req))
        return req

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, a, req = item
            try:
                st = fn(*a)
                req.status = st
                req.complete()
            except MPIException as e:
                req.complete(e)

    def iread_at(self, offset, buf, count=None, datatype=None) -> Request:
        return self._async(self.read_at, offset, _host(buf), count,
                           datatype, self.view)

    def iwrite_at(self, offset, buf, count=None, datatype=None) -> Request:
        return self._async(self.write_at, offset, _host(buf), count,
                           datatype, self.view)

    def iread(self, buf, count=None, datatype=None) -> Request:
        self._check(writing=False)
        buf, count, datatype = _resolve(buf, count, datatype)
        # no EOF clamp for nonblocking ops: the short-read amount is
        # unknowable at issue time, and an outstanding iwrite may extend
        # the file before this read executes — the pointer advances by
        # the full request (standard practice for i-ops)
        old = self._advance(count * datatype.size)
        return self._async(self.read_at, self._etypes(old), buf, count,
                           datatype, self.view)

    def iwrite(self, buf, count=None, datatype=None) -> Request:
        self._check(writing=True)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._advance(count * datatype.size)
        return self._async(self.write_at, self._etypes(old), buf, count,
                           datatype, self.view)

    # nonblocking collectives (MPI-3.1 §13.4.5; one outstanding op per
    # file is the supported discipline — the op's collective exchange
    # runs on the file's private dup comm inside the worker thread)
    def iread_at_all(self, offset, buf, count=None,
                     datatype=None) -> Request:
        return self._async(self.read_at_all, offset, _host(buf), count,
                           datatype, self.view)

    def iwrite_at_all(self, offset, buf, count=None,
                      datatype=None) -> Request:
        return self._async(self.write_at_all, offset, _host(buf), count,
                           datatype, self.view)

    def iread_all(self, buf, count=None, datatype=None) -> Request:
        self._check(writing=False)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._advance(count * datatype.size)
        return self._async(self.read_at_all, self._etypes(old), buf,
                           count, datatype, self.view)

    def iwrite_all(self, buf, count=None, datatype=None) -> Request:
        self._check(writing=True)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._advance(count * datatype.size)
        return self._async(self.write_at_all, self._etypes(old), buf,
                           count, datatype, self.view)

    # ordered-mode split collectives: the rank-ordered base is computed
    # collectively at post time (begin IS collective), the IO overlaps
    def iread_ordered(self, buf, count=None, datatype=None) -> Request:
        self._check(writing=False)
        buf, count, datatype = _resolve(buf, count, datatype)
        my = self._ordered_base(count * datatype.size)
        return self._async(self.read_at, self._etypes(my), buf, count,
                           datatype, self.view)

    def iwrite_ordered(self, buf, count=None, datatype=None) -> Request:
        self._check(writing=True)
        buf, count, datatype = _resolve(buf, count, datatype)
        my = self._ordered_base(count * datatype.size)
        return self._async(self.write_at, self._etypes(my), buf, count,
                           datatype, self.view)

    def iread_shared(self, buf, count=None, datatype=None) -> Request:
        self._check(writing=False)
        buf, count, datatype = _resolve(buf, count, datatype)
        # full advance, no EOF clamp — see iread
        old = self._shared_fetch_add(count * datatype.size)
        return self._async(self.read_at, self._etypes(old), buf, count,
                           datatype, self.view)

    def iwrite_shared(self, buf, count=None, datatype=None) -> Request:
        self._check(writing=True)
        buf, count, datatype = _resolve(buf, count, datatype)
        old = self._shared_fetch_add(count * datatype.size)
        return self._async(self.write_at, self._etypes(old), buf, count,
                           datatype, self.view)

    # -- management ----------------------------------------------------
    def get_size(self) -> int:
        self._check_closed()
        return self.fh.size()

    def set_size(self, size: int) -> None:
        """Collective."""
        self._check(writing=True)
        if self.comm.rank == 0:
            self.fh.resize(size)
        self.comm.barrier()

    def preallocate(self, size: int) -> None:
        self._check(writing=True)
        if self.comm.rank == 0 and self.fh.size() < size:
            self.fh.resize(size)
        self.comm.barrier()

    def get_amode(self) -> int:
        return self.amode

    def get_group(self):
        return self.comm.group

    def get_info(self):
        return dict(self.info)

    def set_info(self, info) -> None:
        self.info.update(_info_dict(info))

    def set_atomicity(self, flag: bool) -> None:
        self.atomicity = bool(flag)

    def get_atomicity(self) -> bool:
        return self.atomicity

    def sync(self) -> None:
        """Collective flush."""
        self._check_closed()
        self.fh.sync()
        self.comm.barrier()

    def close(self) -> None:
        if self.closed:
            return
        if self._worker is not None:      # drain pending i-ops first
            self._q.put(None)
            self._worker.join()
            self._worker = None
        self.comm.barrier()
        self.fh.sync()
        self.fh.close()
        if (self.amode & MODE_DELETE_ON_CLOSE) and self.comm.rank == 0:
            try:
                adio.delete_file(self.filename)
            except MPIException:
                pass
        self.comm.barrier()
        self._sp_win.free()
        self.comm.free()
        self.closed = True

    def __repr__(self):
        return f"File({self.filename!r}, amode={self.amode})"


def file_open(comm, filename: str, amode: int = MODE_RDONLY,
              info=None) -> File:
    return File(comm, filename, amode, info)


def file_delete(filename: str, info=None) -> None:
    adio.delete_file(filename)
