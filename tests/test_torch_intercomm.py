"""The port's intercommunicators (``core/intercomm.py``, ``coll/inter.py``,
``coll/nbc/inter.py``) held against the JAX package on the CPU.

One program runs through the JAX ``run_ranks`` and the port's
``run_ranks(..., device="cpu")`` on the same seeded integer-valued
inputs (float32 and int32): the results are equal bit for bit. Covered:
``intercomm_create`` and the sizes and ranks of both sides at even and
odd splits, point-to-point across, every blocking algorithm of
``COLL_FNS`` with its root semantics (ROOT, PROC_NULL, the remote
root) and its v-variants, every schedule of ``ICOLL_FNS`` (several in
flight at once), the persistent twins, ``merge`` under every pair of
``high`` flags, ``dup``, ``split`` (odd colors, UNDEFINED, a color with
no partner), ``create`` and ``disconnect``. Then what only the port
has: a tensor on the card refused by the intercomm and by a comm merged
with spawned ranks (never staged to the host), and ``bind_derived``
over members the run never bound. Every ``run_ranks`` has a 30 s
timeout.
"""

import types

import numpy as np
import pytest
import torch

from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.core import intercomm as jax_ic
from mvapich2_tpu.core import op as jax_op
from mvapich2_tpu.core import status as jax_status

from mvapich2_tpu_torch import run_ranks
from mvapich2_tpu_torch.coll import inter as port_inter
from mvapich2_tpu_torch.coll.nbc import inter as port_nbc_inter
from mvapich2_tpu_torch.core import errors as port_errors
from mvapich2_tpu_torch.core import intercomm as port_ic
from mvapich2_tpu_torch.core import op as port_op
from mvapich2_tpu_torch.core import status as port_status

from test_torch_pt2pt import TIMEOUT, assert_same, env  # noqa: F401

JAX = types.SimpleNamespace(name="jax", ic=jax_ic, op=jax_op, st=jax_status)
PORT = types.SimpleNamespace(name="port", ic=port_ic, op=port_op,
                             st=port_status)

# (ranks, size of the low side): even, odd and lopsided splits
GEOMS = [(4, 2), (5, 2), (4, 1)]


def _both(n, app):
    """``app(world, lib)`` on ``n`` ranks of each package: (JAX results,
    port results)."""
    j = jax_run_ranks(n, lambda c: app(c, JAX), timeout=TIMEOUT)
    p = run_ranks(n, lambda c: app(c, PORT), device="cpu", timeout=TIMEOUT)
    return j, p


def _make_inter(world, k, lib):
    """Ranks below ``k`` are the low side; the leaders (world ranks 0 and
    ``k``) bridge over the world."""
    low = world.rank < k
    local = world.split(0 if low else 1, world.rank)
    inter = lib.ic.intercomm_create(local, 0, world, k if low else 0,
                                    tag=99)
    return inter, low


def _vals(seed, rank, n, dtype=np.float32):
    rng = np.random.default_rng(seed * 7919 + rank)
    return rng.integers(-1000, 1000, n).astype(dtype)


def test_the_algorithm_tables_are_the_jax_ones():
    from mvapich2_tpu.coll import inter as jax_inter
    from mvapich2_tpu.coll.nbc import inter as jax_nbc_inter
    assert sorted(port_inter.COLL_FNS) == sorted(jax_inter.COLL_FNS)
    assert sorted(port_nbc_inter.ICOLL_FNS) == \
        sorted(jax_nbc_inter.ICOLL_FNS)
    assert port_nbc_inter.NBC_TAG_BASE == jax_nbc_inter.NBC_TAG_BASE
    assert port_status.ROOT == jax_status.ROOT


@pytest.mark.parametrize("n,k", GEOMS)
def test_create_sizes_and_pt2pt(env, n, k):
    """Sizes and ranks of both sides, and a message from every rank to
    every remote rank (point-to-point ranks name the remote group)."""
    def app(world, lib):
        inter, low = _make_inter(world, k, lib)
        rs = inter.remote_size
        got = [np.zeros(3, np.int64) for _ in range(rs)]
        reqs = [inter.irecv(got[j], source=j, tag=5) for j in range(rs)]
        for j in range(rs):
            inter.send(np.array([world.rank, inter.rank, j], np.int64), j,
                       tag=5)
        src = [r.wait().source for r in reqs]
        inter.barrier()
        return (inter.is_inter, inter.size, rs, inter.rank, low,
                list(inter.remote_group.world_ranks), got, src)

    j, p = _both(n, app)
    assert_same(j, p)
    assert [r[1] + r[2] for r in p] == [n] * n


def _bcast(inter, low, lib, world):
    out = []
    for origin_low in (True, False):
        buf = np.zeros(7, np.int32)
        if low == origin_low:
            if inter.rank == 0:
                buf[:] = _vals(1, world.rank, 7, np.int32)
                inter.bcast(buf, root=lib.st.ROOT)
            else:
                inter.bcast(buf, root=lib.st.PROC_NULL)
        else:
            inter.bcast(buf, root=0)
        out.append(buf)
    return out


def _reduce(inter, low, lib, world):
    out = []
    for origin_low, op in ((True, lib.op.SUM), (False, lib.op.MAX)):
        x = _vals(2, world.rank, 33)
        if low == origin_low:
            if inter.rank == 0:
                out.append(inter.reduce(x, root=lib.st.ROOT, op=op))
            else:
                inter.reduce(x, root=lib.st.PROC_NULL, op=op)
        else:
            inter.reduce(x, root=0, op=op)
    return out


def _allreduce(inter, low, lib, world):
    return [inter.allreduce(_vals(3, world.rank, 1000)),
            inter.allreduce(_vals(4, world.rank, 17, np.int32),
                            op=lib.op.MAX)]


def _allgather(inter, low, lib, world):
    return [inter.allgather(_vals(5, world.rank, 3), count=3)]


def _gather(inter, low, lib, world):
    x = _vals(6, world.rank, 4)
    if low:
        if inter.rank == 0:
            return [inter.gather(x, root=lib.st.ROOT, count=4)]
        inter.gather(x, root=lib.st.PROC_NULL)
        return []
    inter.gather(x, root=0)
    return []


def _scatter(inter, low, lib, world):
    if low:
        if inter.rank == 0:
            inter.scatter(_vals(7, world.rank, 2 * inter.remote_size),
                          np.zeros(2, np.float32), root=lib.st.ROOT)
        else:
            inter.scatter(None, None, root=lib.st.PROC_NULL, count=1)
        return []
    rv = np.zeros(2, np.float32)
    inter.scatter(None, rv, root=0)
    return [rv]


def _alltoall(inter, low, lib, world):
    return [inter.alltoall(_vals(8, world.rank, 2 * inter.remote_size),
                           count=2)]


def _gatherv(inter, low, lib, world):
    if low:
        if inter.rank == 0:
            counts = [j + 1 for j in range(inter.remote_size)]
            rb = np.zeros(sum(counts) + 2, np.float32)
            displs = [j * (j + 1) // 2 + j for j in range(len(counts))]
            inter.gatherv(np.zeros(0, np.float32), rb, counts, displs,
                          root=lib.st.ROOT)
            return [rb]
        inter.gatherv(None, None, [0], root=lib.st.PROC_NULL)
        return []
    x = _vals(9, world.rank, inter.rank + 1)
    inter.gatherv(x, None, [inter.rank + 1], root=0)
    return []


def _scatterv(inter, low, lib, world):
    if not low:
        if inter.rank == 0:
            counts = [(j % 3) + 1 for j in range(inter.remote_size)]
            inter.scatterv(_vals(10, world.rank, sum(counts)), counts,
                           None, np.zeros(0, np.float32), root=lib.st.ROOT)
        else:
            inter.scatterv(None, [0], None, None, root=lib.st.PROC_NULL)
        return []
    rv = np.zeros((inter.rank % 3) + 1, np.float32)
    inter.scatterv(None, [rv.size], None, rv, root=0)
    return [rv]


def _allgatherv(inter, low, lib, world):
    counts = [j + 1 for j in range(inter.remote_size)]
    rb = np.zeros(sum(counts), np.float32)
    inter.allgatherv(_vals(11, world.rank, inter.rank + 1), rb, counts)
    return [rb]


def _alltoallv(inter, low, lib, world):
    me, rs = inter.rank, inter.remote_size
    sc = [(me + j) % 3 + 1 for j in range(rs)]
    rc = [(j + me) % 3 + 1 for j in range(rs)]
    sd = [sum(sc[:j]) for j in range(rs)]
    rd = [sum(rc[:j]) + j for j in range(rs)]       # spread displacements
    rb = np.zeros(sum(rc) + rs, np.float32)
    inter.alltoallv(_vals(12, world.rank, sum(sc)), sc, sd, rb, rc, rd)
    return [np.concatenate([rb[rd[j]:rd[j] + rc[j]] for j in range(rs)])]


def _reduce_scatter_block(inter, low, lib, world):
    return [inter.reduce_scatter_block(
        _vals(13, world.rank, 3 * inter.remote_size), count=3)]


def _reduce_scatter(inter, low, lib, world):
    rsum = sum(i + 1 for i in range(inter.remote_size))
    return [inter.reduce_scatter(_vals(14, world.rank, rsum),
                                 counts=[i + 1 for i in range(inter.size)])]


def _barrier(inter, low, lib, world):
    for _ in range(3):
        inter.barrier()
    return []


BLOCKING = {"barrier": _barrier, "bcast": _bcast, "reduce": _reduce,
            "allreduce": _allreduce, "allgather": _allgather,
            "gather": _gather, "scatter": _scatter, "alltoall": _alltoall,
            "gatherv": _gatherv, "scatterv": _scatterv,
            "allgatherv": _allgatherv, "alltoallv": _alltoallv,
            "reduce_scatter": _reduce_scatter,
            "reduce_scatter_block": _reduce_scatter_block}


def test_every_blocking_algorithm_is_covered():
    assert sorted(BLOCKING) == sorted(port_inter.COLL_FNS)


@pytest.mark.parametrize("n,k", GEOMS)
@pytest.mark.parametrize("name", sorted(BLOCKING))
def test_blocking_collectives_bitwise(env, name, n, k):
    def app(world, lib):
        inter, low = _make_inter(world, k, lib)
        out = BLOCKING[name](inter, low, lib, world)
        inter.barrier()
        return out

    j, p = _both(n, app)
    assert_same(j, p)
    if name == "allreduce":
        for r in range(n):
            low = r < k
            remote = [q for q in range(n) if (q < k) != low]
            want = sum(_vals(3, q, 1000) for q in remote)
            np.testing.assert_array_equal(p[r][0], want)


def _nbc_app(k):
    def app(world, lib):
        inter, low = _make_inter(world, k, lib)
        rs = inter.remote_size
        mine = _vals(20, world.rank, 5)
        red = np.zeros(5, np.float32)
        gat = np.zeros(3 * rs, np.float32)
        a2a = np.zeros(2 * rs, np.float32)
        buf = np.zeros(6, np.int32)
        if low and inter.rank == 0:
            buf[:] = _vals(21, world.rank, 6, np.int32)
        root = (lib.st.ROOT if inter.rank == 0 else lib.st.PROC_NULL) \
            if low else 0
        rres = np.zeros(4, np.float32)
        reqs = [inter.ibarrier(),
                inter.iallreduce(mine, red),
                inter.iallgather(_vals(22, world.rank, 3), gat, count=3),
                inter.ialltoall(_vals(23, world.rank, 2 * rs), a2a, count=2),
                inter.ibcast(buf, root=root),
                inter.ireduce(_vals(24, world.rank, 4), rres,
                              op=lib.op.MAX, root=root)]
        for r in reversed(reqs):      # completion order independent
            r.wait()
        return [red, gat, a2a, buf, rres if (low and inter.rank == 0)
                else None]
    return app


@pytest.mark.parametrize("n,k", GEOMS)
def test_nonblocking_schedules_bitwise(env, n, k):
    j, p = _both(n, _nbc_app(k))
    assert_same(j, p)
    assert sorted(port_nbc_inter.ICOLL_FNS) == [
        "iallgather", "iallreduce", "ialltoall", "ibarrier", "ibcast",
        "ireduce"]


def test_proc_null_ranks_keep_the_schedules_paired(env):
    """An ``ibcast`` or ``ireduce`` on a PROC_NULL rank takes its tag
    from the intercomm's counter as the origin's does, so the schedules
    after it still pair. (The JAX package's returns before taking it;
    there the ``iallgather`` below never completes, so this sequence
    runs on the port alone.)"""
    def app(world):
        inter, low = _make_inter(world, 2, PORT)
        rs = inter.remote_size
        root = (port_status.ROOT if inter.rank == 0
                else port_status.PROC_NULL) if low else 0
        buf = _vals(60, 0, 5, np.int32) if (low and inter.rank == 0) \
            else np.zeros(5, np.int32)
        inter.ibcast(buf, root=root).wait()
        red = np.zeros(3, np.float32)
        inter.ireduce(_vals(61, world.rank, 3), red, root=root).wait()
        gat = np.zeros(2 * rs, np.float32)
        inter.iallgather(_vals(62, world.rank, 2), gat, count=2).wait()
        return buf, red, gat

    got = run_ranks(5, app, device="cpu", timeout=TIMEOUT)
    for r in (2, 3, 4):
        np.testing.assert_array_equal(got[r][0], _vals(60, 0, 5, np.int32))
    np.testing.assert_array_equal(
        got[0][1], sum(_vals(61, q, 3) for q in (2, 3, 4)))
    for r in range(5):
        remote = (2, 3, 4) if r < 2 else (0, 1)
        np.testing.assert_array_equal(
            got[r][2], np.concatenate([_vals(62, q, 2) for q in remote]))


def test_persistent_twins_bitwise(env):
    def app(world, lib):
        inter, low = _make_inter(world, 2, lib)
        x = _vals(30, world.rank, 9)
        out = np.zeros(9, np.float32)
        req = inter.allreduce_init(x, out)
        got = []
        for i in range(3):
            x += 1
            req.start()
            req.wait()
            got.append(out.copy())
        return got

    j, p = _both(4, app)
    assert_same(j, p)


@pytest.mark.parametrize("highs", [(False, True), (True, False),
                                   (False, False), (True, True)],
                         ids=["low_low", "low_high", "both_low",
                              "both_high"])
@pytest.mark.parametrize("n,k", GEOMS)
def test_merge_order(env, highs, n, k):
    def app(world, lib):
        inter, low = _make_inter(world, k, lib)
        merged = inter.merge(high=highs[0] if low else highs[1])
        order = merged.allgather(np.array([world.rank], np.int64))
        tot = merged.allreduce(_vals(31, world.rank, 8))
        return merged.rank, merged.size, order, tot

    j, p = _both(n, app)
    assert_same(j, p)
    assert [r[1] for r in p] == [n] * n


def test_dup_split_create_disconnect(env):
    def app(world, lib):
        inter, low = _make_inter(world, 3, lib)
        out = []
        d = inter.dup()
        out.append((d.is_inter, d.size, d.remote_size,
                    d.allreduce(_vals(40, world.rank, 4))))
        d.disconnect()
        # odd colors: the low side's color 1 has no partner, world rank
        # 4 passes UNDEFINED
        color = None if world.rank == 4 else (world.rank % 2 if low
                                               else 0)
        s = inter.split(color, key=-world.rank)
        out.append(None if s is None else
                   (s.size, s.rank, s.remote_size,
                    list(s.remote_group.world_ranks),
                    s.allreduce(_vals(41, world.rank, 3))))
        g = inter.group.incl([0, 1]) if inter.size > 1 else inter.group
        c = inter.create(g)
        out.append(None if c is None else
                   (c.size, c.rank, c.remote_size,
                    c.allreduce(_vals(42, world.rank, 3))))
        inter.disconnect()
        try:
            inter.barrier()
        except Exception as e:      # noqa: BLE001 - the class is compared
            out.append(e.error_class)
        return out

    j, p = _both(6, app)
    assert_same(j, p)
    assert p[0][-1] == port_errors.MPI_ERR_COMM


def test_bad_rank_and_undefined_collective_raise(env):
    """Error classes as the JAX package's: a rank outside the remote
    group, a collective intercomms do not define."""
    def app(world, lib):
        inter, _ = _make_inter(world, 2, lib)
        codes = []
        for call in (lambda: inter.send(np.zeros(1), 5),
                     lambda: inter.scan(np.zeros(1, np.float32))):
            try:
                call()
            except Exception as e:      # noqa: BLE001
                codes.append(e.error_class)
        inter.barrier()
        return codes

    j, p = _both(4, app)
    assert_same(j, p)
    assert p[0] == [port_errors.MPI_ERR_RANK, port_errors.MPI_ERR_COMM]


# ---------------------------------------------------------------------------
# what the port alone does: no device path, and never a hidden one
# ---------------------------------------------------------------------------

def _card(n, dtype=torch.float32):
    """A tensor that does not lie on the CPU: the meta device stands in
    for the card here (as ``tests/test_torch_host_coll.py`` ``_card``)."""
    return torch.empty(n, dtype=dtype, device="meta")


def _spawned_merge(world):
    """Spawn two children (thread mode) and merge with them; the children
    end at a barrier of the merged comm, which the caller must join."""
    from mvapich2_tpu_torch.runtime import spawn
    inter, _ = spawn.comm_spawn(world, lambda cw: spawn.get_parent(
        cw.u).merge(high=True).barrier(), maxprocs=2)
    return inter.merge(high=False)


def _merged_spawned_allreduce(world, inter):
    merged = _spawned_merge(world)
    try:
        merged.allreduce(_card(64))
    finally:
        merged.barrier()


def _root(c):
    """The bcast/gather root of world rank ``c.rank`` with low side 0, 1."""
    if c.rank >= 2:
        return 0
    return port_status.ROOT if c.rank == 0 else port_status.PROC_NULL


# (case, the call on each rank, what the refusal must name)
_CARD_CASES = [
    ("inter_allreduce", lambda c, i: i.allreduce(_card(64)), "intercomm"),
    ("inter_bcast", lambda c, i: i.bcast(_card(8), root=_root(c)),
     "intercomm"),
    ("inter_gather", lambda c, i: i.gather(_card(4), root=_root(c)),
     "intercomm"),
    ("inter_alltoall", lambda c, i: i.alltoall(_card(4), count=2),
     "intercomm"),
    ("inter_allgatherv", lambda c, i: i.allgatherv(
        _card(1), np.zeros(2, np.float32), [1, 1]),
     "allgatherv on intercommunicator"),
    ("inter_iallreduce", lambda c, i: i.iallreduce(
        _card(64), np.zeros(64, np.float32)),
     "iallreduce on intercommunicator"),
    ("inter_reduce_scatter_block", lambda c, i: i.reduce_scatter_block(
        _card(4), count=2), "intercomm"),
    ("merged_spawned", _merged_spawned_allreduce, "spawned processes"),
]


@pytest.mark.parametrize("case,call,names", _CARD_CASES,
                         ids=[c[0] for c in _CARD_CASES])
def test_card_tensor_refused_on_intercomms(env, case, call, names):
    """A tensor on the card in an intercomm call, or in a call on a comm
    merged with spawned ranks, raises NotImplementedError naming the
    comm and why, on every rank, before any data moves; nothing is
    staged to the host (``to_host`` raises while the calls run)."""
    from mvapich2_tpu_torch.coll import inter as inter_mod
    from mvapich2_tpu_torch.core import comm as comm_mod

    def app(world):
        inter, _ = _make_inter(world, 2, PORT)
        with pytest.raises(NotImplementedError, match=names) as ei:
            call(world, inter)
        world.barrier()
        return str(ei.value)

    def no_staging(t):
        raise AssertionError("a tensor on the card was staged")
    real = (inter_mod.to_host, comm_mod.to_host)
    inter_mod.to_host = comm_mod.to_host = no_staging
    try:
        got = run_ranks(4, app, device="cpu", timeout=TIMEOUT)
    finally:
        inter_mod.to_host, comm_mod.to_host = real
    assert all("is not moved to the host" in g for g in got), got


def test_cpu_tensors_run_in_place(env):
    """A CPU tensor in an intercomm call is read and written in place as
    numpy, with the result of the numpy call."""
    def app(world):
        inter, low = _make_inter(world, 2, PORT)
        t = torch.from_numpy(_vals(50, world.rank, 16))
        out = torch.zeros(16)
        req = inter.iallreduce(t, out)
        req.wait()
        ref = inter.allreduce(_vals(50, world.rank, 16))
        return torch.equal(out, torch.from_numpy(ref))

    assert run_ranks(4, app, device="cpu", timeout=TIMEOUT) == [True] * 4


@pytest.mark.parametrize("geom", [None, (4,)], ids=["slot", "mesh"])
def test_bind_derived_over_unbound_members(env, geom):
    """A comm whose members include world ids the run never bound (the
    merge of a spawn intercomm) binds nothing on every member, raises no
    IndexError and names those members in ``unbound_why``; an intercomm
    itself binds nothing, and a merge within the run binds as a dup."""
    from mvapich2_tpu_torch import make_mesh
    from mvapich2_tpu_torch.coll.device import bind_derived
    from mvapich2_tpu_torch.core.comm import Comm
    from mvapich2_tpu_torch.core.group import Group

    def app(world):
        u = world.u
        c = Comm(u, Group([0, 1, 2, 3, 9]), 9000 + 2, "outside")
        bind_derived(c)
        inter, low = _make_inter(world, 2, PORT)
        same_run = inter.merge(high=not low)
        spawned = _spawned_merge(world)
        spawned.barrier()
        return (c.device_channel is None, c.unbound_why,
                inter.device_channel, same_run.device_channel is not None,
                spawned.device_channel, spawned.unbound_why)

    mesh = make_mesh(geom, ("x",), "cpu") if geom else None
    got = run_ranks(4, app, device="cpu" if mesh is None else None,
                    device_mesh=mesh, timeout=TIMEOUT)
    for none, why, ich, bound, sch, swhy in got:
        assert none and "[9]" in why and "spawned" in why
        assert ich is None and bound and sch is None
        assert "[4, 5]" in swhy
