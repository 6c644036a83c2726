"""ADIO, the file-access layer under MPI-IO (a copy of the JAX package's
``io/adio.py``).

Two drivers behind one open/read/write/resize contract:

  * ``ufs``: POSIX files through ``os.pread``/``os.pwrite`` (positional,
    so rank processes and IO threads never race a shared seek pointer);
  * ``memfs``: a process-global in-memory store (thread ranks of one
    process see one namespace). Each package keeps its own store.

A file name picks its driver by prefix, "ufs:fname" or "memfs:fname";
a bare path is ufs. The amode bits carry the MPI-3.1 values of mpi.h.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

from ..core.datatype import as_bytes_view
from ..core.errors import (MPIException, MPI_ERR_AMODE, MPI_ERR_FILE,
                           MPI_ERR_IO, MPI_ERR_NO_SUCH_FILE)

# MPI_File amode bits (MPI-3.1 §13.2.1 values as in mpi.h)
MODE_RDONLY = 2
MODE_RDWR = 8
MODE_WRONLY = 4
MODE_CREATE = 1
MODE_EXCL = 64
MODE_DELETE_ON_CLOSE = 16
MODE_UNIQUE_OPEN = 32
MODE_SEQUENTIAL = 256
MODE_APPEND = 128


def parse_filename(filename: str) -> Tuple[str, str]:
    """'driver:path' -> (driver, path); bare paths mean ufs."""
    if ":" in filename:
        drv, _, path = filename.partition(":")
        if drv in _DRIVERS:
            return drv, path
    return "ufs", filename


class ADIOFile:
    """One opened file on one rank (the fd-level contract)."""

    def read_at(self, offset: int, nbytes: int) -> bytes:
        raise NotImplementedError

    def write_at(self, offset: int, data) -> int:
        raise NotImplementedError

    def read_into(self, offset: int, mv: memoryview) -> int:
        """Read directly into a writable byte view (zero extra copy when
        the driver supports it); returns bytes read."""
        b = self.read_at(offset, len(mv))
        mv[:len(b)] = b
        return len(b)

    def size(self) -> int:
        raise NotImplementedError

    def resize(self, size: int) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def lock_all(self) -> None:
        """Whole-file advisory lock (atomic-mode read-modify-write)."""

    def unlock_all(self) -> None:
        pass


class UfsFile(ADIOFile):
    def __init__(self, path: str, amode: int):
        flags = 0
        if amode & MODE_RDWR:
            flags |= os.O_RDWR
        elif amode & MODE_WRONLY:
            flags |= os.O_WRONLY
        else:
            flags |= os.O_RDONLY
        if amode & MODE_CREATE:
            flags |= os.O_CREAT
        if amode & MODE_EXCL:
            flags |= os.O_EXCL
        # note: MPI MODE_APPEND only positions file pointers at EOF
        # (io/file.py); O_APPEND must NOT be set — pwrite on an O_APPEND
        # fd ignores the offset and lands at EOF on Linux
        try:
            self.fd = os.open(path, flags, 0o644)
        except FileNotFoundError as e:
            raise MPIException(MPI_ERR_NO_SUCH_FILE, str(e)) from e
        except OSError as e:
            raise MPIException(MPI_ERR_IO, f"open {path!r}: {e}") from e
        self.path = path

    # Linux caps a single pread/pwrite at MAX_RW_COUNT (2 GiB - 4 KiB)
    # and either may be partial anyway — always loop (bigtype.c writes
    # 2^31 bytes in one MPI call and checks the last bytes)
    def read_at(self, offset: int, nbytes: int) -> bytes:
        chunks = []
        got = 0
        try:
            while got < nbytes:
                b = os.pread(self.fd, min(nbytes - got, 1 << 30),
                             offset + got)
                if not b:
                    break
                chunks.append(b)
                got += len(b)
        except OSError as e:
            raise MPIException(MPI_ERR_IO, f"pread: {e}") from e
        return chunks[0] if len(chunks) == 1 else b"".join(chunks)

    def write_at(self, offset: int, data) -> int:
        mv = as_bytes_view(data)
        total = 0
        try:
            while total < len(mv):
                n = os.pwrite(self.fd, mv[total:total + (1 << 30)],
                              offset + total)
                if n <= 0:
                    break
                total += n
        except OSError as e:
            raise MPIException(MPI_ERR_IO, f"pwrite: {e}") from e
        return total

    def read_into(self, offset: int, mv: memoryview) -> int:
        total = 0
        try:
            while total < len(mv):
                n = os.preadv(self.fd, [mv[total:total + (1 << 30)]],
                              offset + total)
                if n <= 0:
                    break
                total += n
        except OSError as e:
            raise MPIException(MPI_ERR_IO, f"preadv: {e}") from e
        return total

    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def resize(self, size: int) -> None:
        os.ftruncate(self.fd, size)

    def sync(self) -> None:
        os.fsync(self.fd)

    def lock_all(self) -> None:
        import fcntl
        fcntl.lockf(self.fd, fcntl.LOCK_EX)

    def unlock_all(self) -> None:
        import fcntl
        fcntl.lockf(self.fd, fcntl.LOCK_UN)

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass


# shared in-process store for memfs (thread-mode ranks see one namespace)
_MEMFS: Dict[str, bytearray] = {}
_MEMFS_LOCKS: Dict[str, threading.RLock] = {}
_MEMFS_GUARD = threading.Lock()


class MemFile(ADIOFile):
    def __init__(self, path: str, amode: int):
        with _MEMFS_GUARD:
            exists = path in _MEMFS
            if not exists:
                if not (amode & MODE_CREATE):
                    raise MPIException(MPI_ERR_NO_SUCH_FILE,
                                       f"memfs:{path} does not exist")
                _MEMFS[path] = bytearray()
                _MEMFS_LOCKS[path] = threading.RLock()
            elif amode & MODE_EXCL:
                raise MPIException(MPI_ERR_AMODE,
                                   f"memfs:{path} exists (MODE_EXCL)")
            self.buf = _MEMFS[path]
            self.lock = _MEMFS_LOCKS[path]
        self.path = path

    def read_at(self, offset: int, nbytes: int) -> bytes:
        with self.lock:
            return bytes(self.buf[offset:offset + nbytes])

    def write_at(self, offset: int, data) -> int:
        mv = as_bytes_view(data)
        n = len(mv)
        with self.lock:
            if offset + n > len(self.buf):
                self.buf.extend(b"\0" * (offset + n - len(self.buf)))
            self.buf[offset:offset + n] = mv
        return n

    def size(self) -> int:
        with self.lock:
            return len(self.buf)

    def resize(self, size: int) -> None:
        with self.lock:
            if size < len(self.buf):
                del self.buf[size:]
            else:
                self.buf.extend(b"\0" * (size - len(self.buf)))

    def sync(self) -> None:
        pass

    def lock_all(self) -> None:
        self.lock.acquire()

    def unlock_all(self) -> None:
        self.lock.release()

    def close(self) -> None:
        pass

    @staticmethod
    def delete(path: str) -> None:
        with _MEMFS_GUARD:
            if path not in _MEMFS:
                raise MPIException(MPI_ERR_NO_SUCH_FILE, f"memfs:{path}")
            del _MEMFS[path]
            _MEMFS_LOCKS.pop(path, None)


_DRIVERS = {"ufs": UfsFile, "memfs": MemFile}


def open_file(filename: str, amode: int) -> ADIOFile:
    n_access = sum(1 for bit in (MODE_RDONLY, MODE_WRONLY, MODE_RDWR)
                   if amode & bit)
    if n_access != 1:
        raise MPIException(MPI_ERR_AMODE,
                           "exactly one of RDONLY, WRONLY, RDWR required")
    if (amode & MODE_SEQUENTIAL) and (amode & MODE_RDWR):
        raise MPIException(MPI_ERR_AMODE, "SEQUENTIAL with RDWR")
    drv, path = parse_filename(filename)
    return _DRIVERS[drv](path, amode)


def delete_file(filename: str) -> None:
    drv, path = parse_filename(filename)
    if drv == "memfs":
        MemFile.delete(path)
        return
    try:
        os.unlink(path)
    except FileNotFoundError as e:
        raise MPIException(MPI_ERR_NO_SUCH_FILE, str(e)) from e
    except OSError as e:
        raise MPIException(MPI_ERR_IO, str(e)) from e
