"""The port's point-to-point tier, communicators and groups held against
the JAX package on the CPU.

One program runs through the JAX ``run_ranks`` (its host tier) and the
port's ``run_ranks(..., device="cpu")``: both return the same values,
and the ``pt2pt_*`` and ``coll_*_calls`` pvars move by the same amounts.
Covered: eager and rendezvous (RGET and RPUT) across the eager
thresholds, on one node and across two (``nodes=``), ANY_SOURCE/ANY_TAG,
ordering, waitall/waitany, sendrecv and sendrecv_replace (zero-length
and 4 MiB both ways), probe/iprobe, improbe/mrecv, truncation, ssend,
PROC_NULL, self-sends, persistent requests, cancel of a posted receive
and of unmatched sends, derived datatypes, a tensor refused with
MPI_ERR_ARG, and dup/split/create/split_type_shared/build_2level/
compare/free, and the Group set operations. Every ``run_ranks`` has a
timeout of at most 30 s.

The other host-tier test files import the helpers here (``run_both``,
``PORT``, ``JAX``, ``env``).
"""

import types

import numpy as np
import pytest
import torch

from mvapich2_tpu import mpit as jax_mpit
from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.coll import shmcoll as jax_shmcoll
from mvapich2_tpu.coll.api import IN_PLACE as JAX_IN_PLACE
from mvapich2_tpu.core import datatype as jax_dt
from mvapich2_tpu.core import errors as jax_errors
from mvapich2_tpu.core import group as jax_group
from mvapich2_tpu.core import op as jax_op
from mvapich2_tpu.core import request as jax_request
from mvapich2_tpu.core import status as jax_status
from mvapich2_tpu.utils.config import get_config as jax_config

from mvapich2_tpu_torch import mpit, run_ranks
from mvapich2_tpu_torch.core import datatype as port_dt
from mvapich2_tpu_torch.core import errors as port_errors
from mvapich2_tpu_torch.core import group as port_group
from mvapich2_tpu_torch.core import op as port_op
from mvapich2_tpu_torch.core import request as port_request
from mvapich2_tpu_torch.core import status as port_status
from mvapich2_tpu_torch.core.comm import IN_PLACE as PORT_IN_PLACE
from mvapich2_tpu_torch.utils.config import get_config

TIMEOUT = 30

JAX = types.SimpleNamespace(name="jax", dt=jax_dt, op=jax_op,
                            st=jax_status, err=jax_errors,
                            req=jax_request, group=jax_group,
                            IN_PLACE=JAX_IN_PLACE)
PORT = types.SimpleNamespace(name="port", dt=port_dt, op=port_op,
                             st=port_status, err=port_errors,
                             req=port_request, group=port_group,
                             IN_PLACE=PORT_IN_PLACE)


def _counters(registry):
    """The pt2pt and collective-algorithm counters of one package."""
    return {k: v.read() for k, v in registry.items()
            if k.startswith("pt2pt_") or (k.startswith("coll_")
                                          and k.endswith("_calls"))}


def _deltas(registry, fn):
    before = _counters(registry)
    out = fn()
    after = _counters(registry)
    return out, {k: v - before.get(k, 0.0) for k, v in after.items()
                 if v - before.get(k, 0.0)}


def run_both(n, app, nodes=None, device_mesh=None, jax_mesh=None,
             pvars=True):
    """``app(comm, lib)`` on ``n`` ranks of each package: (JAX results,
    port results); asserts equal pt2pt and coll_*_calls pvar deltas
    unless ``pvars`` is False."""
    jres, jd = _deltas(jax_mpit._pvars._vars, lambda: jax_run_ranks(
        n, lambda c: app(c, JAX), nodes=nodes, timeout=TIMEOUT,
        device_mesh=jax_mesh))
    pres, pd = _deltas(mpit._pvars, lambda: run_ranks(
        n, lambda c: app(c, PORT), device="cpu" if device_mesh is None
        else None, nodes=nodes, timeout=TIMEOUT, device_mesh=device_mesh))
    if pvars:
        assert jd == pd, (jd, pd)
    return jres, pres


def assert_same(a, b):
    """Bitwise equality of nested results (arrays compared as bytes,
    with dtype and shape)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (type(a), type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        if a.dtype.names:       # a pair type: its padding is not data
            for f in a.dtype.names:
                assert_same(np.ascontiguousarray(a[f]),
                            np.ascontiguousarray(b[f]))
            return
        assert a.tobytes() == b.tobytes(), (a, b)
    else:
        assert a == b, (a, b)


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages (the
    JAX ``run_ranks`` reloads its config from the environment) and
    reloads both configs. The JAX in-process ranks find no shared-memory
    segment or arena (``shmcoll._segment_for`` and
    ``_node_exchange_ctx`` patched to None), so its large-message
    allreduce and bcast take the branches the port runs (with a segment
    they move the same values through it instead of the point-to-point
    protocol: ``test_torch_host_coll.py`` checks those results too). The
    teardown restores the environment and both configs."""
    monkeypatch.setattr(jax_shmcoll, "_segment_for", lambda comm: None)
    monkeypatch.setattr(jax_shmcoll, "_node_exchange_ctx",
                        lambda comm: None)
    def set_env(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(f"MV2T_{k}", raising=False)
            else:
                monkeypatch.setenv(f"MV2T_{k}", str(v))
        jax_config().reload()
        get_config().reload()
    yield set_env
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()


def _status(st):
    return None if st is None else (st.source, st.tag, st.count,
                                    bool(st.cancelled))


# ---------------------------------------------------------------------------
# eager / rendezvous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbytes", [0, 4, 32 * 1024, 32 * 1024 + 4,
                                    64 * 1024, 64 * 1024 + 4, 4 << 20])
@pytest.mark.parametrize("nodes", [None, [0, 1]], ids=["one_node", "two"])
def test_send_recv_thresholds(env, nbytes, nodes):
    """A send of ``nbytes`` goes eager up to SMP_EAGERSIZE (32 KiB) on
    one node and EAGER_THRESHOLD (64 KiB) across two, rendezvous above:
    the pvar deltas and the received bytes match."""
    def app(comm, lib):
        n = nbytes // 4
        if comm.rank == 0:
            comm.send(np.arange(n, dtype=np.int32) * 3, dest=1, tag=7)
            return None
        buf = np.full(n, -1, np.int32)
        st = comm.recv(buf, source=0, tag=7)
        return buf, _status(st)

    j, p = run_both(2, app, nodes=nodes)
    assert_same(j, p)
    assert p[1][1] == (0, 7, nbytes, False)


@pytest.mark.parametrize("proto", ["RGET", "RPUT", "R3"])
def test_rendezvous_protocols(env, proto):
    """The rendezvous protocol cvar: RGET pulls, RPUT and R3 push DATA
    chunks of R3_CHUNK_SIZE (64 KiB here: a 1 MiB float64 message in 16
    chunks)."""
    env(RNDV_PROTOCOL=proto, R3_CHUNK_SIZE=str(64 * 1024))
    n = 1 << 17

    def app(comm, lib):
        if comm.rank == 0:
            comm.send(np.arange(n, dtype=np.float64), dest=1)
            return None
        buf = np.zeros(n, np.float64)
        return buf, _status(comm.recv(buf, source=0))

    j, p = run_both(2, app)
    assert_same(j, p)
    assert p[1][0][-1] == n - 1


def test_any_source_any_tag(env):
    """Seven senders into ANY_SOURCE/ANY_TAG receives on rank 0."""
    def app(comm, lib):
        if comm.rank == 0:
            buf = np.zeros(1, dtype=np.int32)
            seen = []
            for _ in range(comm.size - 1):
                st = comm.recv(buf, source=lib.st.ANY_SOURCE,
                               tag=lib.st.ANY_TAG)
                assert buf[0] == st.source * 100 + st.tag
                seen.append(st.source)
            return sorted(seen)
        comm.send(np.array([comm.rank * 100 + comm.rank], np.int32),
                  dest=0, tag=comm.rank)
        return None

    j, p = run_both(8, app)
    assert j[0] == p[0] == list(range(1, 8))


def test_nonovertaking_order(env):
    """Fifty messages of one envelope, eager and rendezvous interleaved,
    arrive in the order sent."""
    def app(comm, lib):
        out = []
        for i in range(50):
            n = 1 if i % 5 else 20000       # every fifth goes rendezvous
            if comm.rank == 0:
                comm.send(np.full(n, i, np.int64), dest=1, tag=5)
            else:
                buf = np.zeros(n, np.int64)
                comm.recv(buf, source=0, tag=5)
                out.append(int(buf[0]))
        return out

    j, p = run_both(2, app)
    assert j == p and p[1] == list(range(50))


def test_isend_irecv_waitall_waitany(env):
    def app(comm, lib):
        peer = 1 - comm.rank
        sbuf = np.full(64, comm.rank, np.int32)
        rbuf = np.zeros(64, np.int32)
        reqs = [comm.irecv(rbuf, source=peer, tag=1),
                comm.isend(sbuf, dest=peer, tag=1)]
        lib.req.waitall(reqs)
        b1 = np.zeros(1, np.int32)
        b2 = np.zeros(1, np.int32)
        if comm.rank == 0:
            comm.send(np.array([1], np.int32), dest=1, tag=11)
            return rbuf
        r1 = comm.irecv(b1, source=0, tag=10)
        r2 = comm.irecv(b2, source=0, tag=11)
        idx = lib.req.waitany([r1, r2])
        r1.cancel()
        r1.wait()
        return rbuf, idx, b2, bool(r1.status.cancelled)

    j, p = run_both(2, app)
    assert_same(j, p)
    assert p[1][1] == 1 and p[1][3]


@pytest.mark.parametrize("n", [0, 1 << 20], ids=["zero", "4MiB"])
def test_sendrecv_bidirectional(env, n):
    """sendrecv around a ring and between pairs, zero-length and 4 MiB
    both ways at once (rendezvous in both directions), and
    sendrecv_replace."""
    def app(comm, lib):
        right = (comm.rank + 1) % comm.size
        left = (comm.rank - 1) % comm.size
        sbuf = np.arange(n, dtype=np.int32) + comm.rank
        rbuf = np.full(n, -1, np.int32)
        st = comm.sendrecv(sbuf, right, 3, rbuf, left, 3)
        peer = comm.rank ^ 1
        rb2 = np.zeros(n, np.int32)
        st2 = comm.sendrecv(sbuf, peer, 4, rb2, peer, 4)
        buf = np.array([comm.rank], np.int32)
        comm.sendrecv_replace(buf, peer, 0, peer, 0)
        return rbuf, _status(st), rb2, _status(st2), buf

    j, p = run_both(4, app)
    assert_same(j, p)


def test_probe_iprobe_mprobe(env):
    def app(comm, lib):
        if comm.rank == 0:
            comm.send(np.arange(5, dtype=np.float64), dest=1, tag=42)
            comm.send(np.array([123], np.int64), dest=1, tag=9)
            comm.send(np.arange(30000, dtype=np.int32), dest=1, tag=10)
            return None
        st = comm.probe(source=0, tag=42)
        buf = np.zeros(st.count // 8, np.float64)
        comm.recv(buf, source=0, tag=42)
        none = comm.iprobe(source=0, tag=42)
        msg = None
        while msg is None:
            msg = comm.improbe(source=0, tag=9)
        b9 = np.zeros(1, np.int64)
        st9 = comm.mrecv(msg, b9)
        stb = comm.probe(source=lib.st.ANY_SOURCE, tag=10)
        big = None
        while big is None:
            big = comm.improbe(source=0, tag=lib.st.ANY_TAG)
        b10 = np.zeros(30000, np.int32)
        st10 = comm.mrecv(big, b10)
        return (_status(st), buf, none, b9, _status(st9), _status(stb),
                b10, _status(st10))

    j, p = run_both(2, app)
    assert_same(j, p)


def test_truncation_error(env):
    def app(comm, lib):
        if comm.rank == 0:
            comm.send(np.arange(10, dtype=np.int32), dest=1)
            comm.send(np.arange(20000, dtype=np.int32), dest=1)
            return None
        out = []
        for n in (5, 100):
            buf = np.zeros(n, dtype=np.int32)
            with pytest.raises(lib.err.MPIException) as exc:
                comm.recv(buf, source=0)
            out.append((exc.value.error_class, buf))
        return out

    j, p = run_both(2, app)
    assert_same(j, p)
    assert p[1][0][0] == port_errors.MPI_ERR_TRUNCATE


@pytest.mark.parametrize("mode", ["ssend", "bsend", "rsend", "issend"])
def test_send_modes(env, mode):
    """ssend completes only after the match (rendezvous however small),
    bsend completes at once, rsend is standard mode."""
    def app(comm, lib):
        if comm.rank == 0:
            data = np.arange(4, dtype=np.int32)
            if mode == "issend":
                req = comm.issend(data, dest=1, tag=2)
                req.wait()
            else:
                getattr(comm, mode)(data, dest=1, tag=2)
            return None
        import time
        time.sleep(0.05)
        buf = np.zeros(4, np.int32)
        comm.recv(buf, source=0, tag=2)
        return buf

    j, p = run_both(2, app)
    assert_same(j, p)


def test_proc_null_and_self_send(env):
    def app(comm, lib):
        comm.send(np.zeros(1, np.int32), dest=lib.st.PROC_NULL)
        st = comm.recv(np.zeros(1, np.int32), source=lib.st.PROC_NULL)
        buf = np.arange(16, dtype=np.int32)
        req = comm.isend(buf, dest=comm.rank, tag=3)
        req.wait()          # eager: locally complete
        buf[:] = -1         # a legal overwrite after completion
        out = np.zeros(16, np.int32)
        comm.recv(out, source=comm.rank, tag=3)
        return st.source, st.tag, out

    j, p = run_both(2, app)
    assert_same(j, p)
    assert p[0][0] == port_status.PROC_NULL


def test_persistent_requests(env):
    def app(comm, lib):
        peer = 1 - comm.rank
        sbuf = np.zeros(8, np.int32)
        rbuf = np.zeros(8, np.int32)
        sreq = comm.send_init(sbuf, dest=peer, tag=4)
        rreq = comm.recv_init(rbuf, source=peer, tag=4)
        got = []
        for it in range(3):
            sbuf[...] = comm.rank * 10 + it
            rreq.start()
            sreq.start()
            sreq.wait()
            rreq.wait()
            got.append(rbuf.copy())
        return got

    j, p = run_both(2, app)
    assert_same(j, p)


@pytest.mark.parametrize("n", [1, 20000], ids=["eager", "rndv"])
def test_cancel(env, n):
    """A posted receive cancels; an unmatched send (eager or rendezvous)
    is retracted from the peer's unexpected queue; a matched one is
    not."""
    def app(comm, lib):
        out = []
        buf = np.zeros(1, np.int32)
        req = comm.irecv(buf, source=1 - comm.rank, tag=99)
        req.cancel()
        st = req.wait()
        out.append(bool(st.cancelled))
        if comm.rank == 0:
            sreq = comm.isend(np.zeros(n, np.int32), dest=1, tag=77)
            sreq.cancel()
            sreq.wait()
            out.append(bool(sreq.status.cancelled))
        comm.barrier()
        if comm.rank == 1:
            out.append(comm.iprobe(source=0, tag=77) is None)
        comm.barrier()
        if comm.rank == 0:
            sreq = comm.isend(np.ones(n, np.int32), dest=1, tag=78)
        else:
            rb = np.zeros(n, np.int32)
            comm.recv(rb, source=0, tag=78)
            out.append(rb)
        comm.barrier()
        if comm.rank == 0:
            sreq.cancel()
            sreq.wait()
            out.append(bool(sreq.status.cancelled))
        comm.barrier()      # rank 1 answers the cancel from in here
        return out

    j, p = run_both(2, app)
    assert_same(j, p)
    assert p[0] == [True, True, False] and p[1][:2] == [True, True]


def test_derived_datatype_transfer(env):
    """A vector type on both sides, a struct of an int and a double
    packed by hand, and contiguous/indexed/resized receives."""
    def app(comm, lib):
        dt = lib.dt
        t = dt.create_vector(4, 1, 2, dt.INT).commit()
        idx = dt.create_indexed([2, 1], [0, 5], dt.INT).commit()
        if comm.rank == 0:
            a = np.arange(8, dtype=np.int32)
            comm.send(a, dest=1, count=1, datatype=t)
            comm.send(np.arange(8, dtype=np.int32) + 10, dest=1, count=1,
                      datatype=idx)
            big = np.arange(2 * 30000, dtype=np.int32)
            comm.send(big, dest=1, count=30000,
                      datatype=dt.create_vector(1, 1, 2, dt.INT).commit())
            return None
        out = np.zeros(8, dtype=np.int32)
        comm.recv(out, source=0, count=1, datatype=t)
        o2 = np.zeros(8, np.int32)
        comm.recv(o2, source=0, count=1, datatype=idx)
        o3 = np.zeros(60000, np.int32)
        st = comm.recv(o3, source=0, count=30000,
                       datatype=dt.create_resized(dt.INT, 0, 8).commit())
        return out, o2, o3, st.count

    j, p = run_both(2, app)
    assert_same(j, p)
    assert list(p[1][0][::2]) == [0, 2, 4, 6]


def test_tensor_buffer_refused(env):
    """A tensor in a point-to-point buffer is refused with MPI_ERR_ARG,
    as the JAX package refuses a jax.Array (no quiet host copy): a send
    at once, a receive when the message lands in it."""
    import jax.numpy as jnp

    def app(comm, lib):
        dev = torch.ones(4) if lib is PORT else jnp.ones(4)
        with pytest.raises(lib.err.MPIException) as ei:
            if comm.rank == 0:
                try:
                    comm.send(dev, dest=1)
                finally:
                    comm.send(np.ones(4, np.float32), dest=1)
            else:
                comm.recv(torch.zeros(4) if lib is PORT
                          else jnp.zeros(4), source=0)
        return ei.value.error_class

    j, p = run_both(2, app)
    assert j == p == [port_errors.MPI_ERR_ARG] * 2


# ---------------------------------------------------------------------------
# communicators
# ---------------------------------------------------------------------------

def test_dup_isolated_context(env):
    def app(comm, lib):
        dup = comm.dup()
        peer = 1 - comm.rank
        a = np.array([1], np.int32)
        b = np.array([2], np.int32)
        ra = np.zeros(1, np.int32)
        rb = np.zeros(1, np.int32)
        r1 = comm.irecv(ra, source=peer, tag=0)
        r2 = dup.irecv(rb, source=peer, tag=0)
        dup.send(b, dest=peer, tag=0)
        comm.send(a, dest=peer, tag=0)
        r1.wait()
        r2.wait()
        res = (dup.size, dup.rank, dup.context_id, ra, rb,
               comm.compare(comm), comm.compare(dup))
        dup.free()
        return res

    j, p = run_both(2, app)
    assert_same(j, p)


@pytest.mark.parametrize("case", ["parity", "undefined", "key_reorders",
                                  "churn", "create", "shared", "2level"])
def test_split_create(env, case):
    nodes = {"shared": [0, 0, 0, 0, 1, 1, 1, 1],
             "2level": [0, 0, 1, 1, 2, 2]}.get(case)
    n = {"parity": 8, "shared": 8, "2level": 6}.get(case, 4)

    def app(comm, lib):
        if case == "parity":
            sub = comm.split(comm.rank % 2, key=comm.rank)
            return (sub.size, sub.rank, sub.context_id,
                    sub.allgather(np.array([comm.rank], np.int32)))
        if case == "undefined":
            sub = comm.split(None if comm.rank == 0 else 5)
            return None if sub is None else (sub.size, sub.rank)
        if case == "key_reorders":
            return comm.split(0, key=-comm.rank).rank
        if case == "churn":
            ids = set()
            for _ in range(20):
                sub = comm.split(1, key=comm.rank)
                ids.add(sub.context_id)
                sub.free()
                assert comm.split(None) is None
            return sorted(ids)
        if case == "create":
            sub = comm.create(comm.group.incl([0, 2]))
            if sub is None:
                return None
            return sub.size, sub.allgather(np.array([comm.rank], np.int32))
        if case == "shared":
            node = comm.split_type_shared()
            return node.size, node.allgather(np.array([comm.rank],
                                                      np.int32))
        shmem, leader = comm.build_2level()
        return shmem.size, None if leader is None else leader.size

    j, p = run_both(n, app, nodes=nodes)
    assert_same(j, p)


def _type_cases(dt):
    """Derived-type constructions of tests/test_noncommutative.py and
    the pt2pt tests, with their bounds and spans."""
    base = dt.create_resized(dt.create_contiguous(4, dt.BYTE), -3, 9)
    neg = dt.create_resized(dt.create_contiguous(4, dt.BYTE), 6, -9)
    return {
        "vector": dt.create_vector(4, 1, 2, dt.INT),
        "neg_stride": dt.create_vector(2, 1, -1, dt.INT),
        "hindexed_neg": dt.create_hindexed([1, 1], [0, -8], dt.DOUBLE),
        "sticky_vector": dt.create_vector(3, 1, 1, base),
        "sticky_contig": dt.create_contiguous(3, base),
        "neg_extent": dt.create_contiguous(3, neg),
        "indexed": dt.create_indexed([2, 1, 3], [0, 5, 9], dt.FLOAT),
        "indexed_block": dt.create_indexed_block(2, [1, 6], dt.SHORT),
        "struct": dt.create_struct([1, 2], [0, 8], [dt.INT, dt.DOUBLE]),
        "subarray": dt.create_subarray([4, 6], [2, 3], [1, 2], dt.INT),
        "big_hvector": dt.create_hvector(40, 2, 12, dt.INT),
    }


def test_datatype_constructors_match_jax():
    """Every ported constructor gives the JAX package's size, bounds and
    spans; pack and unpack move the same bytes; the negative-displacement
    guard raises in both."""
    port, ref = _type_cases(port_dt), _type_cases(jax_dt)
    buf = (np.arange(4096) % 251).astype(np.uint8)
    for k in ref:
        a, b = port[k], ref[k]
        assert (a.size, a.lb, a.extent, a.ub) == (b.size, b.lb, b.extent,
                                                  b.ub), k
        assert a.spans.tolist() == b.spans.tolist(), k
        if a.needs_abs(2):
            with pytest.raises(port_errors.MPIException):
                a.pack(buf, 2)
            continue
        packed = a.pack(buf, 2)
        assert packed.tobytes() == b.pack(buf, 2).tobytes(), k
        out_a, out_b = np.zeros(4096, np.uint8), np.zeros(4096, np.uint8)
        a.unpack(packed, out_a, 2)
        b.unpack(packed, out_b, 2)
        assert out_a.tobytes() == out_b.tobytes(), k
    for name in ("FLOAT_INT", "DOUBLE_INT", "TWOINT", "LONG_INT",
                 "SHORT_INT", "BFLOAT16", "HALF", "C_BOOL", "COMPLEX"):
        a, b = getattr(port_dt, name), getattr(jax_dt, name)
        assert (a.size, a.extent, a.basic) == (b.size, b.extent, b.basic)
    for t, n in ((torch.float32, np.float32), (torch.int64, np.int64),
                 (torch.uint8, np.uint8), (torch.bool, np.bool_)):
        assert port_dt.from_numpy_dtype(t) is port_dt.from_numpy_dtype(n)
    assert port_dt.from_numpy_dtype(torch.bfloat16) is port_dt.BFLOAT16


def test_group_set_operations():
    """incl/excl/union/intersection/difference/translate/range/compare
    give the JAX package's groups."""
    out = []
    for G, st in ((jax_group.Group, jax_status),
                  (port_group.Group, port_status)):
        g = G(range(10))
        a, b = G([0, 1, 2, 3]), G([2, 3, 4, 5])
        out.append((g.incl([1, 3, 5]).world_ranks,
                    g.excl([0, 7]).world_ranks,
                    a.union(b).world_ranks, a.intersection(b).world_ranks,
                    a.difference(b).world_ranks,
                    a.translate_ranks([0, 3, st.PROC_NULL], G([3, 2, 1, 0])),
                    a.translate_ranks([1], G([5, 6])),
                    g.range_incl([(0, 8, 2)]).world_ranks,
                    g.range_incl([(9, 5, -2)]).world_ranks,
                    g.range_excl([(0, 8, 2)]).world_ranks,
                    a.compare(G([0, 1, 2, 3])), a.compare(G([3, 2, 1, 0])),
                    a.compare(G([0, 1])), g.rank_of_world(5),
                    g.world_of_rank(3)))
    assert out[0] == out[1]
    with pytest.raises(port_errors.MPIException):
        port_group.Group([1, 1])
