"""The port's MPI-IO (``io/``: the ufs and memfs drivers, file views,
two-phase collective IO, shared and ordered pointers, nonblocking IO)
held against the JAX package on the CPU.

Each program runs through the JAX ``run_ranks`` and the port's
``run_ranks(..., device="cpu")`` on seeded numpy inputs. Each package
writes its own file (a memfs name or a path under ``tmp_path`` of its
own: the two packages keep separate memfs stores), and the bytes read
back, the statuses' counts, the pointers and the error classes must be
equal, bit for bit. Covered: every case of ``tests/test_io.py`` (memfs
and ufs, the individual pointer and seek, a vector view, two-phase
``write_at_all``/``read_at_all``, shared and ordered pointers,
nonblocking IO, set_size/preallocate and MODE_APPEND, the amode errors,
delete-on-close, a strided view read back through itself).

The shared pointers run on host windows: the JAX engine runs with the
port's inline-drain rule patched in (``test_torch_rma_host.py``
``jax_drain``).

What the port alone does: a CPU tensor is written from and read into in
place, and a tensor that does not lie on the CPU (a meta tensor stands
for the card) raises ``NotImplementedError`` on every rank before the
file or a pointer moves. Every ``run_ranks`` takes the shared 30 s
timeout.
"""

import types
import uuid

import numpy as np
import pytest
import torch

from mvapich2_tpu import io as jax_io

from mvapich2_tpu_torch import run_ranks
from mvapich2_tpu_torch import io as port_io

from test_torch_pt2pt import (JAX, PORT, TIMEOUT, assert_same,  # noqa: F401
                              env, run_both)
from test_torch_rma_host import jax_drain  # noqa: F401

JAXI = types.SimpleNamespace(**vars(JAX), io=jax_io)
PORTI = types.SimpleNamespace(**vars(PORT), io=port_io)


def _rw(lib):
    return lib.io.MODE_RDWR | lib.io.MODE_CREATE


def _both(n, app, tmp_path, ufs=False):
    """``app(comm, lib, name)`` on both packages, each on a file of its
    own; asserts bitwise equal results and returns the port's."""
    tag = uuid.uuid4().hex[:8]

    def name_of(lib):
        if ufs:
            return str(tmp_path / f"{lib.name}-{tag}.bin")
        return f"memfs:iotest-{lib.name}-{tag}"

    def run(comm, lib):
        lib = JAXI if lib.name == "jax" else PORTI
        return app(comm, lib, name_of(lib))
    j, p = run_both(n, run)
    assert_same(j, p)
    return p


def _ints(comm, seed, n, dt):
    return np.random.default_rng(seed + comm.rank).integers(
        -1000, 1000, n).astype(dt)


def _raw(f, nbytes):
    """The file's first ``nbytes`` bytes through a byte view."""
    f.set_view()
    raw = np.zeros(nbytes, np.uint8)
    st = f.read_at(0, raw)
    return raw, st.count


def _code(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - both packages' classes
        return getattr(e, "error_class", type(e).__name__)
    return None


# ---------------------------------------------------------------------------
# the cases of tests/test_io.py
# ---------------------------------------------------------------------------

def write_read_at(comm, lib, name):
    f = lib.io.file_open(comm, name, _rw(lib))
    st = f.write_at(comm.rank * 64, _ints(comm, 1, 16, np.int32))
    f.sync()
    comm.barrier()
    other = np.zeros(16, np.int32)
    st2 = f.read_at(((comm.rank + 1) % comm.size) * 64, other)
    size = f.get_size()
    comm.barrier()
    raw = _raw(f, 64 * comm.size)
    f.close()
    return st.count, st2.count, other, size, raw


def pointer_and_seek(comm, lib, name):
    f = lib.io.file_open(comm, name, _rw(lib))
    out = None
    if comm.rank == 0:
        f.write(_ints(comm, 2, 10, np.int64))
        pos = f.get_position()
        f.seek(16, lib.io.SEEK_SET)
        buf = np.zeros(2, np.int64)
        st = f.read(buf)
        f.seek(-8, lib.io.SEEK_END)
        last = np.zeros(1, np.int64)
        st2 = f.read(last, count=1)
        f.seek(0, lib.io.SEEK_END)
        eof = np.zeros(4, np.int64)
        st3 = f.read(eof)                 # at EOF: count 0
        out = (pos, buf, st.count, last, st2.count, st3.count,
               f.get_position(), f.get_byte_offset(3))
    f.close()
    return out


def vector_view(comm, lib, name):
    dt = lib.dt
    P = comm.size
    f = lib.io.file_open(comm, name, _rw(lib))
    ft = dt.create_resized(dt.create_vector(1, 4, 4 * P, dt.INT), 0,
                           4 * P * dt.INT.size)
    f.set_view(disp=comm.rank * 4 * dt.INT.size, etype=dt.INT, filetype=ft)
    st = f.write_at(0, _ints(comm, 3, 8, np.int32))
    off = f.get_byte_offset(5)
    f.sync()
    comm.barrier()
    raw = _raw(f, 8 * P * 4)
    f.close()
    return st.count, off, raw


def write_at_all_two_phase(comm, lib, name):
    dt = lib.dt
    P = comm.size
    f = lib.io.file_open(comm, name, _rw(lib))
    ft = dt.create_resized(dt.create_vector(1, 2, 2 * P, dt.INT), 0,
                           2 * P * dt.INT.size)
    f.set_view(disp=comm.rank * 2 * dt.INT.size, etype=dt.INT, filetype=ft)
    mine = _ints(comm, 4, 6, np.int32)
    st = f.write_at_all(0, mine)
    f.sync()
    comm.barrier()
    back = np.zeros(6, np.int32)
    st2 = f.read_at_all(0, back)
    raw = _raw(f, 6 * P * 4)
    comm.barrier()
    f.close()
    return st.count, st2.count, back, raw


def shared_pointer(comm, lib, name):
    f = lib.io.file_open(comm, name, _rw(lib))
    st = f.write_shared(np.full(4, comm.rank, np.int32))
    f.sync()
    comm.barrier()
    pos = f.get_position_shared()
    comm.barrier()
    f.seek_shared(0)
    # a drain: every 16-byte record is read exactly once, then EOF
    got, rec = [], np.zeros(4, np.int32)
    while f.read_shared(rec).count:
        got.append(int(rec[0]))
    counts = comm.allgather(np.array([len(got)], np.int64), count=1)
    records = sorted(comm.allgather(np.array(
        got + [-1] * (comm.size - len(got)), np.int64), count=comm.size)
        .tolist())
    end = f.get_position_shared()
    comm.barrier()
    f.close()
    return st.count, pos, int(counts.sum()), records, end


def ordered_write(comm, lib, name):
    f = lib.io.file_open(comm, name, _rw(lib))
    st = f.write_ordered(_ints(comm, 5, 3, np.int32))
    f.sync()
    comm.barrier()
    raw = _raw(f, 12 * comm.size)
    comm.barrier()
    f.seek_shared(0)
    back = np.zeros(3, np.int32)
    st2 = f.read_ordered(back)
    f.close()
    return st.count, raw, st2.count, back


def nonblocking_io(comm, lib, name):
    f = lib.io.file_open(comm, name, _rw(lib))
    mine = np.random.default_rng(6 + comm.rank).standard_normal(1000) \
        .astype(np.float32)
    st = f.iwrite_at(comm.rank * 4000, mine).wait()
    f.sync()
    comm.barrier()
    back = np.zeros(1000, np.float32)
    st2 = f.iread_at(((comm.rank + 1) % comm.size) * 4000, back).wait()
    comm.barrier()
    both = np.zeros(500, np.float32)
    st3 = f.iread_at_all(comm.rank * 2000, both).wait()
    f.close()
    return st.count, st2.count, back, st3.count, both


def set_size_preallocate_append(comm, lib, name):
    f = lib.io.file_open(comm, name, _rw(lib))
    f.set_size(256)
    sizes = [f.get_size()]
    comm.barrier()
    f.preallocate(128)
    sizes.append(f.get_size())
    comm.barrier()
    f.set_size(16)
    sizes.append(f.get_size())
    f.close()
    g = lib.io.file_open(comm, name, lib.io.MODE_RDWR | lib.io.MODE_APPEND)
    pos = g.get_position()
    comm.barrier()
    if comm.rank == 0:
        g.write(_ints(comm, 7, 4, np.int32))
    g.sync()
    comm.barrier()
    sizes.append(g.get_size())
    raw = _raw(g, 32)
    g.close()
    return sizes, pos, raw


def amode_errors(comm, lib, name):
    f = lib.io.file_open(comm, name, lib.io.MODE_WRONLY | lib.io.MODE_CREATE)
    c1 = _code(lambda: f.read_at(0, np.zeros(4, np.uint8)))
    f.close()
    g = lib.io.file_open(comm, name, lib.io.MODE_RDONLY)
    c2 = _code(lambda: g.write_at(0, np.zeros(4, np.uint8)))
    g.close()
    missing = name + "-missing"
    c3 = _code(lambda: lib.io.file_open(comm, missing, lib.io.MODE_RDONLY))
    c4 = _code(lambda: lib.io.file_open(
        comm, name, lib.io.MODE_RDONLY | lib.io.MODE_RDWR))
    c5 = _code(lambda: g.read_at(0, np.zeros(1, np.uint8)))   # closed
    return c1, c2, c3, c4, c5


def delete_on_close(comm, lib, name):
    f = lib.io.file_open(comm, name, _rw(lib) | lib.io.MODE_DELETE_ON_CLOSE)
    st = f.write_at(comm.rank * 4, _ints(comm, 8, 4, np.uint8))
    f.close()
    comm.barrier()
    return st.count, _code(lambda: lib.io.file_open(comm, name,
                                                    lib.io.MODE_RDONLY))


def view_read_back(comm, lib, name):
    dt = lib.dt
    f = lib.io.file_open(comm, name, _rw(lib))
    ft = dt.create_resized(dt.create_vector(1, 1, 2, dt.DOUBLE), 0,
                           2 * dt.DOUBLE.size)
    f.set_view(disp=(comm.rank % 2) * dt.DOUBLE.size, etype=dt.DOUBLE,
               filetype=ft)
    mine = np.random.default_rng(9 + comm.rank).standard_normal(5)
    st = f.write_at(0, mine)
    f.sync()
    comm.barrier()
    back = np.zeros(5, np.float64)
    st2 = f.read_at(0, back)
    comm.barrier()
    raw = _raw(f, 80)
    f.close()
    return st.count, st2.count, back, raw


IO_CASES = {
    "write_read_at_memfs": (4, write_read_at, False),
    "ufs_backend": (2, write_read_at, True),
    "pointer_and_seek": (2, pointer_and_seek, False),
    "vector_view_partitioning": (4, vector_view, False),
    "write_at_all_two_phase": (4, write_at_all_two_phase, False),
    "shared_pointer": (4, shared_pointer, False),
    "ordered_write": (4, ordered_write, False),
    "nonblocking_io": (2, nonblocking_io, True),
    "set_size_preallocate_append": (2, set_size_preallocate_append, True),
    "amode_errors": (1, amode_errors, False),
    "delete_on_close": (2, delete_on_close, True),
    "view_read_back_through_view": (2, view_read_back, False),
}


@pytest.mark.parametrize("case", list(IO_CASES))
def test_io_case_equals_jax(env, tmp_path, case):
    n, app, ufs = IO_CASES[case]
    p = _both(n, app, tmp_path, ufs)
    from mvapich2_tpu_torch.core import errors as e
    if case in ("write_read_at_memfs", "ufs_backend"):
        for r, (c1, c2, other, size, raw) in enumerate(p):
            assert (c1, c2, size) == (64, 64, 64 * n)
            peer = (r + 1) % n
            np.testing.assert_array_equal(
                other, np.random.default_rng(1 + peer).integers(
                    -1000, 1000, 16).astype(np.int32))
    elif case == "shared_pointer":
        for st, pos, total, records, end in p:
            assert (st, pos, total, end) == (16, 16 * n, n, 16 * n)
            assert [x for x in records if x >= 0] == list(range(n))
    elif case == "write_at_all_two_phase":
        for r, (c1, c2, back, _) in enumerate(p):
            assert (c1, c2) == (24, 24)
            np.testing.assert_array_equal(back, np.random.default_rng(
                4 + r).integers(-1000, 1000, 6).astype(np.int32))
    elif case == "amode_errors":
        assert p[0] == (e.MPI_ERR_AMODE, e.MPI_ERR_READ_ONLY,
                        e.MPI_ERR_NO_SUCH_FILE, e.MPI_ERR_AMODE,
                        e.MPI_ERR_FILE)
    elif case == "delete_on_close":
        assert p == [(4, e.MPI_ERR_NO_SUCH_FILE)] * n
    elif case == "set_size_preallocate_append":
        assert p[0][:2] == ([256, 256, 16, 32], 16)


# ---------------------------------------------------------------------------
# what the port alone does
# ---------------------------------------------------------------------------

def _card(n, dtype=torch.int32):
    """A tensor that does not lie on the CPU: the meta device stands in
    for the card (as ``tests/test_torch_intercomm.py`` ``_card``)."""
    return torch.empty(n, dtype=dtype, device="meta")


def test_cpu_tensors_in_place_and_card_tensors_refused(tmp_path):
    name = str(tmp_path / "port.bin")

    def app(comm):
        f = port_io.file_open(comm, name, port_io.MODE_RDWR
                              | port_io.MODE_CREATE)
        src = torch.arange(8, dtype=torch.int32) + 100 * comm.rank
        st = f.write_at_all(comm.rank * 32, src)
        back = torch.zeros(8, dtype=torch.int32)
        st2 = f.read_at(((comm.rank + 1) % comm.size) * 32, back)
        refused = 0
        for call in (lambda: f.write_at(0, _card(4)),
                     lambda: f.read_at(0, _card(4)),
                     lambda: f.write_at_all(0, _card(4)),
                     lambda: f.iwrite_at(0, _card(4)),
                     lambda: f.iread_at_all(0, _card(4)),
                     lambda: f.write(_card(4)),
                     lambda: f.write_shared(_card(4)),
                     lambda: f.write_ordered(_card(4))):
            try:
                call()
            except NotImplementedError:
                refused += 1
        pos, shared = f.get_position(), f.get_position_shared()
        comm.barrier()
        size = f.get_size()
        f.close()
        return st.count, st2.count, back, refused, pos, shared, size

    res = run_ranks(4, app, device="cpu", timeout=TIMEOUT)
    for r, (c1, c2, back, refused, pos, shared, size) in enumerate(res):
        assert (c1, c2, refused, pos, shared, size) == (32, 32, 8, 0, 0, 128)
        assert torch.equal(back, torch.arange(8, dtype=torch.int32)
                           + 100 * ((r + 1) % 4))
