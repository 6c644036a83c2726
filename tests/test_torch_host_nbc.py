"""The port's host NBC schedule (``coll/nonblocking.py`` over the
send/recv/call vertices of ``coll/nbc``) held against the JAX package on
the CPU.

Every builder: ibarrier, ibcast, iallreduce (commutative and not),
iallgather, ialltoall, ireduce, iscan, iexscan, igather(v), iscatter(v),
iallgatherv, ialltoallv, ireduce_scatter(_block), and the persistent
barrier_init/reduce_init, at 1, 2, 3, 5 and 8 ranks, several posted at
once and ended by waitall; results bitwise, ``coll_*``/``pt2pt_*`` pvar
deltas equal (``test_torch_pt2pt.run_both``). The port's COMM_WORLD is
bound to the slot channel, whose device tier refuses i-collectives, so
they count ``dev_coll_fallback_nbc`` and run here, as in the JAX package.
Then the DAG machinery as ``tests/test_nonblocking.py`` checks it:
dependency order, the issue order of a batch, an error's unwind, the
cancel of an in-flight schedule, completion-driven progression and
overlap with compute.
"""

import numpy as np
import pytest

from mvapich2_tpu_torch import mpit, run_ranks
from mvapich2_tpu_torch.coll.nbc import dag as port_dag
from mvapich2_tpu_torch.coll.nbc.engine import start as port_start
from mvapich2_tpu_torch.coll.nonblocking import Sched
from mvapich2_tpu_torch.core import errors as port_errors

from test_torch_pt2pt import TIMEOUT, assert_same, env, run_both  # noqa: F401

NRANKS = [1, 2, 3, 5, 8]


def _data(rank, n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed * 1000 + rank)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    return rng.integers(-1000, 1000, n).astype(dtype)


def _matmul_op(lib):
    def f(invec, inout):
        a = invec.reshape(-1, 2, 2)
        b = inout.reshape(-1, 2, 2)
        return np.matmul(a, b).reshape(invec.shape)
    return lib.op.create_op(f, commute=False)


def _icoll_app(comm, lib):
    """Every host builder, posted together, then waitall."""
    r, p = comm.rank, comm.size
    reqs, outs = [], {}

    def post(name, req, out):
        reqs.append(req)
        outs[name] = out

    post("ibarrier", comm.ibarrier(), None)
    b = _data(r, 700) if r == p - 1 else np.zeros(700, np.float32)
    post("ibcast", comm.ibcast(b, root=p - 1), b)
    ar = np.zeros(3000, np.float32)
    post("iallreduce", comm.iallreduce(_data(r, 3000), ar), ar)
    arm = np.zeros(8, np.float64)
    m = np.tile(np.array([1.0, r + 1, 0.0, 1.0]), 2) * (1 + r / 10)
    post("iallreduce_noncomm", comm.iallreduce(m, arm, op=_matmul_op(lib)),
         arm)
    ag = np.zeros(5 * p, np.int32)
    post("iallgather", comm.iallgather(_data(r, 5, np.int32), ag), ag)
    a2 = np.zeros(4 * p, np.int32)
    post("ialltoall", comm.ialltoall(_data(r, 4 * p, np.int32), a2), a2)
    rd = np.zeros(64, np.float32)
    post("ireduce", comm.ireduce(_data(r, 64), rd, root=0), rd)
    sc = np.zeros(32, np.float32)
    post("iscan", comm.iscan(_data(r, 32), sc), sc)
    ex = np.zeros(32, np.float32)
    post("iexscan", comm.iexscan(_data(r, 32), ex), ex)
    ga = np.zeros(6 * p, np.int32) if r == 1 % p else None
    post("igather", comm.igather(_data(r, 6, np.int32), ga, root=1 % p), ga)
    sa = np.zeros(3, np.float32)
    post("iscatter", comm.iscatter(_data(r, 3 * p) if r == 0 else None, sa,
                                   root=0), sa)
    counts = [(2 * k + 1) % 4 for k in range(p)]
    displs = [sum(counts[:k]) for k in range(p)]
    gv = np.zeros(sum(counts), np.int32) if r == 0 else None
    post("igatherv", comm.igatherv(np.full(counts[r], r + 1, np.int32), gv,
                                   counts, displs, root=0), gv)
    sv = np.zeros(counts[r], np.int32)
    post("iscatterv", comm.iscatterv(
        np.arange(sum(counts), dtype=np.int32) if r == p - 1 else None,
        counts, displs, sv, root=p - 1), sv)
    agv = np.zeros(sum(counts), np.int32)
    post("iallgatherv", comm.iallgatherv(
        np.full(counts[r], r + 5, np.int32), agv, counts, displs), agv)
    scn = [(r + k) % 3 for k in range(p)]
    rcn = [(k + r) % 3 for k in range(p)]
    av = np.zeros(sum(rcn), np.float32)
    post("ialltoallv", comm.ialltoallv(
        _data(r, sum(scn)), scn, [sum(scn[:k]) for k in range(p)], av, rcn,
        [sum(rcn[:k]) for k in range(p)]), av)
    rcounts = [k + 1 for k in range(p)]
    rs = np.zeros(rcounts[r], np.float32)
    post("ireduce_scatter", comm.ireduce_scatter(
        _data(r, sum(rcounts)), rs, rcounts), rs)
    rsb = np.zeros(7, np.float32)
    post("ireduce_scatter_block", comm.ireduce_scatter_block(
        _data(r, 7 * p), rsb), rsb)
    lib.req.waitall(reqs)
    if r == 0:
        outs["iexscan"] = None       # rank 0's exscan result is undefined
    if r != 0:
        outs["ireduce"] = None
    return outs


@pytest.mark.parametrize("n", NRANKS)
def test_host_builders_match_jax(env, n):
    j, p = run_both(n, _icoll_app)
    assert_same(j, p)


def test_nonblocking_fallback_counted_on_the_slot_channel(env):
    """The slot channel's COMM_WORLD counts every i-collective that has a
    device twin as dev_coll_fallback_nbc and runs it on the host
    schedule; a dup (its numpy calls take the host schedule as a comm
    with no channel, in both packages) counts nothing."""
    def app(comm):
        out = np.zeros(16, np.float32)
        comm.iallreduce(np.ones(16, np.float32), out).wait()
        comm.ibarrier().wait()
        comm.dup().iallreduce(np.ones(16, np.float32), out).wait()
        return out

    before = mpit.pvar("dev_coll_fallback_nbc").read()
    for out in run_ranks(4, app, device="cpu", timeout=TIMEOUT):
        assert (out == 4).all()
    assert mpit.pvar("dev_coll_fallback_nbc").read() - before == 4


@pytest.mark.parametrize("kind", ["barrier", "reduce", "allreduce"])
def test_persistent_host_collectives(env, kind):
    """barrier_init / reduce_init / allreduce_init re-post their host
    schedules on every start()."""
    def app(comm, lib):
        out = []
        x = np.zeros(10, np.float32)
        rb = np.zeros(10, np.float32)
        req = {"barrier": lambda: comm.barrier_init(),
               "reduce": lambda: comm.reduce_init(x, rb, root=0),
               "allreduce": lambda: comm.allreduce_init(x, rb)}[kind]()
        for it in range(3):
            x[:] = _data(comm.rank, 10, seed=it)
            req.start()
            req.wait()
            out.append(rb.copy())
        return out

    j, p = run_both(3, app)
    assert_same(j, p)


def test_error_in_completion(env):
    """A tensor recvbuf on the host schedule: the last CALL's unpack
    fails on every rank, and wait() raises it (MPI_ERR_ARG), as with a
    jax.Array in the JAX package."""
    import jax.numpy as jnp
    import torch

    def app(comm, lib):
        bad = torch.zeros(8) if lib.name == "port" else jnp.zeros(8)
        req = comm.iallreduce(np.ones(8, np.float32), bad)
        with pytest.raises(lib.err.MPIException) as ei:
            req.wait()
        return ei.value.error_class

    j, p = run_both(3, app)
    assert j == p == [port_errors.MPI_ERR_ARG] * 3


# ---------------------------------------------------------------------------
# the DAG machinery (tests/test_nonblocking.py's cases on the port)
# ---------------------------------------------------------------------------

def test_dag_dependency_ordering():
    def fn(comm):
        order = []
        dag = port_dag.SchedDAG()
        a = dag.call(lambda: order.append("a"))
        b = dag.call(lambda: order.append("b"), after=[a])
        c = dag.call(lambda: order.append("c"), after=[b])
        d = dag.call(lambda: order.append("d"))      # independent root
        e = dag.call(lambda: order.append("e"), after=[c, d])
        dag.call(lambda: order.append("f"), after=[e])
        port_start(comm, dag).wait()
        assert order.index("a") < order.index("b") < order.index("c")
        assert order.index("c") < order.index("e") < order.index("f")
        assert order.index("d") < order.index("e")
        return True

    assert all(run_ranks(1, fn, device="cpu", timeout=TIMEOUT))


def test_dag_batch_issue_order():
    """In one ready batch, local calls run before receives are posted,
    and receives before sends go out."""
    dag = port_dag.SchedDAG()
    s = dag.send(None, np.zeros(1, np.uint8), 0, 42)
    r = dag.recv(None, np.zeros(1, np.uint8), 0, 42)
    c = dag.call(lambda: None)
    batch = sorted([s, r, c], key=lambda v: dag.vertices[v].kind)
    assert [dag.vertices[v].kind for v in batch] == \
        [port_dag.CALL, port_dag.RECV, port_dag.SEND]


def test_sched_error_unwind():
    """A failing local op completes the rank's request with
    MPI_ERR_INTERN; its peers are unaffected."""
    def fn(comm):
        s = Sched(comm, comm.next_coll_tag())
        s.send(np.zeros(1, np.uint8), (comm.rank + 1) % comm.size)
        s.recv(np.zeros(1, np.uint8), (comm.rank - 1) % comm.size)
        s.barrier()
        if comm.rank == 0:
            s.call(lambda: (_ for _ in ()).throw(ValueError("boom")))
        req = s.start()
        if comm.rank == 0:
            with pytest.raises(port_errors.MPIException) as ei:
                req.wait()
            assert ei.value.error_class == port_errors.MPI_ERR_INTERN
        else:
            req.wait()
        return True

    assert all(run_ranks(3, fn, device="cpu", timeout=TIMEOUT))


def test_sched_cancel_inflight():
    def fn(comm):
        if comm.rank == 0:
            s = Sched(comm, 12345)
            s.recv(np.zeros(8, np.uint8), 1)   # never sent: in flight
            req = s.start()
            assert not req.complete_flag
            req.cancel()
            st = req.wait()
            assert st.cancelled and req.cancelled
        comm.barrier()
        return True

    assert all(run_ranks(2, fn, device="cpu", timeout=TIMEOUT))
    assert mpit.pvar("nbc_scheds_active").read() == 0


def test_wakeup_driven_progression():
    """Schedules advance from completion callbacks: nbc_wakeups moves,
    and futile polls stay below the vertices issued."""
    fut = mpit.pvar("nbc_futile_polls")
    wak = mpit.pvar("nbc_wakeups")
    iss = mpit.pvar("nbc_vertices_issued")
    f0, w0, i0 = fut.read(), wak.read(), iss.read()

    def fn(comm):
        for _ in range(10):
            rb = np.zeros(64)
            comm.iallreduce(np.full(64, float(comm.rank + 1)), rb).wait()
            np.testing.assert_allclose(rb, sum(range(1, comm.size + 1)))
        return True

    assert all(run_ranks(4, fn, device="cpu", timeout=TIMEOUT))
    df, dw, di = fut.read() - f0, wak.read() - w0, iss.read() - i0
    assert di > 0 and dw > 0
    assert df < di, (df, di)


def test_overlap_compute():
    def fn(comm):
        sb = np.full(100000, float(comm.rank))
        rb = np.zeros(100000)
        req = comm.iallreduce(sb, rb)
        acc = 0.0
        for _ in range(50):
            acc += float(np.sum(np.ones(1000)))
        req.wait()
        np.testing.assert_allclose(rb, sum(range(comm.size)))
        return acc

    assert run_ranks(4, fn, device="cpu", timeout=TIMEOUT) == [50000.0] * 4
