"""The port's attribute caching (``core/attr.py``), ``MPI_Info``
(``core/info.py``), generalized requests (``core/request.py``
``Grequest``), ``Comm.create_group`` and the datatype additions
(``create_darray``, ``dup``, ``attrs``, ``get_envelope``) held against
the JAX package on the CPU.

Programs run through the JAX ``run_ranks`` and the port's
``run_ranks(..., device="cpu")`` and return what the callbacks saw and
what ``get`` returned, never keyval ids (both packages draw them from a
process-wide counter). Covered: a keyval's copy and delete on ``dup``
and ``free`` (and a ``delete_fn`` that runs a collective on the comm
being freed), overwrite and delete, a freed keyval
(``MPI_ERR_KEYVAL``), datatype attributes across ``Datatype.dup`` and
every constructor's envelope, ``Info``, a ``Grequest`` completed from
another thread (query, free, cancel before and after completion; the
waiter woken by the engine's doorbell), ``create_group`` over one group
and over two disjoint groups at once (and two threads of each rank
agreeing at once), and ``create_darray``'s spans and extents for block,
cyclic(2) and none in C and Fortran order, bit for bit. Every
``run_ranks`` takes the shared 30 s timeout.
"""

import threading
import time
import types

import numpy as np
import pytest

from mvapich2_tpu.core import attr as jax_attr
from mvapich2_tpu.core import datatype as jax_dt
from mvapich2_tpu.core import errors as jax_errors
from mvapich2_tpu.core import group as jax_group
from mvapich2_tpu.core import info as jax_info
from mvapich2_tpu.core import request as jax_request

from mvapich2_tpu_torch import mpi, run_ranks
from mvapich2_tpu_torch.core import attr as port_attr
from mvapich2_tpu_torch.core import datatype as port_dt
from mvapich2_tpu_torch.core import errors as port_errors
from mvapich2_tpu_torch.core import group as port_group
from mvapich2_tpu_torch.core import info as port_info
from mvapich2_tpu_torch.core import request as port_request

from test_torch_pt2pt import TIMEOUT, assert_same, env, run_both  # noqa: F401

JAX = types.SimpleNamespace(name="jax", attr=jax_attr, dt=jax_dt,
                            err=jax_errors, group=jax_group, info=jax_info,
                            req=jax_request)
PORT = types.SimpleNamespace(name="port", attr=port_attr, dt=port_dt,
                             err=port_errors, group=port_group,
                             info=port_info, req=port_request)


def _both(n, app, pvars=True):
    def run(comm, lib):
        return app(comm, JAX if lib.name == "jax" else PORT)
    return run_both(n, run, pvars=pvars)


def _code(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - both packages' classes
        return getattr(e, "error_class", type(e).__name__)
    return None


# ---------------------------------------------------------------------------
# keyvals on communicators
# ---------------------------------------------------------------------------

def test_keyval_copy_and_delete_on_dup_and_free(env):
    """The ``tests/test_comm.py`` case: copy_fn doubles on dup, delete_fn
    fires on free and on delete; a keyval with no copy_fn is not copied;
    an overwrite deletes the old value first."""
    def app(comm, lib):
        copies, deletes = [], []
        kv = lib.attr.Keyval(
            copy_fn=lambda obj, k, extra, val: (copies.append(val) or
                                                (True, val * 2)),
            delete_fn=lambda obj, k, val, extra: deletes.append(
                (val, extra)), extra="x")
        nocopy = lib.attr.Keyval(delete_fn=lambda obj, k, val, extra:
                                 deletes.append(("nocopy", val)))
        refuse = lib.attr.Keyval(copy_fn=lambda obj, k, extra, val:
                                 (False, None))
        base = 20 + comm.rank
        comm.attrs.set(comm, kv, base)
        comm.attrs.set(comm, nocopy, "n")
        comm.attrs.set(comm, refuse, "r")
        out = [comm.attrs.get(kv)]
        dup = comm.dup()
        out += [dup.attrs.get(kv), dup.attrs.get(nocopy),
                dup.attrs.get(refuse)]
        dup2 = dup.dup()
        out.append(dup2.attrs.get(kv))
        dup.attrs.set(dup, kv, 7)            # overwrite: deletes the old
        dup.free()
        dup2.free()
        comm.attrs.delete(comm, kv)
        out += [comm.attrs.get(kv), comm.attrs.get(nocopy)]
        comm.attrs.delete(comm, nocopy)
        out += [list(copies), list(deletes)]
        return out

    j, p = _both(3, app)
    assert_same(j, p)
    r0 = p[0]
    assert r0[0] == (True, 20) and r0[1] == (True, 40)
    assert r0[2] == (False, None) and r0[3] == (False, None)
    assert r0[4] == (True, 80)
    assert r0[-1] == [(40, "x"), (7, "x"), (80, "x"), (20, "x"),
                      ("nocopy", "n")]


def test_delete_fn_runs_a_collective_on_the_comm(env):
    """``free`` runs the delete callbacks before it releases the comm, so
    a delete_fn may still call a collective on it."""
    def app(comm, lib):
        seen = []

        def delete(obj, k, val, extra):
            seen.append(obj.allreduce(np.array([val], np.int64)))
        kv = lib.attr.Keyval(delete_fn=delete)
        d = comm.dup()
        d.attrs.set(d, kv, comm.rank + 1)
        d.free()
        return seen, d.freed

    j, p = _both(4, app)
    assert_same(j, p)
    assert int(p[0][0][0][0]) == 10


def test_freed_keyval(env):
    def app(comm, lib):
        kv = lib.attr.Keyval()
        comm.attrs.set(comm, kv, 1)
        kv.freed = True
        # the attribute set before the free stays readable (MPI-3.1
        # §6.7.2: a freed keyval lives on while attributes use it)
        return (_code(lambda: comm.attrs.set(comm, kv, 2)),
                comm.attrs.get(kv), lib.attr.KEYVAL_INVALID)

    j, p = _both(2, app)
    assert_same(j, p)
    assert p[0][0] == port_errors.MPI_ERR_KEYVAL


def test_intercomm_dup_copies_attributes(env):
    def app(comm, lib):
        from mvapich2_tpu.core import intercomm as jic
        from mvapich2_tpu_torch.core import intercomm as pic
        ic = jic if lib.name == "jax" else pic
        low = comm.rank < 2
        local = comm.split(0 if low else 1, comm.rank)
        inter = ic.intercomm_create(local, 0, comm, 2 if low else 0, tag=5)
        kv = lib.attr.Keyval(copy_fn=lambda o, k, e, v: (True, v + 1))
        inter.attrs.set(inter, kv, comm.rank)
        return inter.dup().attrs.get(kv)

    j, p = _both(4, app)
    assert_same(j, p)


# ---------------------------------------------------------------------------
# datatypes: attributes, dup, envelopes, darray
# ---------------------------------------------------------------------------

def _types(lib):
    dt = lib.dt
    return {
        "named": dt.INT,
        "contiguous": dt.create_contiguous(3, dt.INT),
        "vector": dt.create_vector(3, 2, 4, dt.DOUBLE),
        "hvector": dt.create_hvector(2, 1, 24, dt.INT),
        "hvector_fast": dt.create_hvector(20, 1, 8, dt.INT),
        "indexed": dt.create_indexed([1, 2], [0, 3], dt.INT),
        "hindexed": dt.create_hindexed([2, 1], [0, 16], dt.INT),
        "hindexed_fast": dt.create_hindexed([1] * 20, list(range(0, 80, 4)),
                                            dt.INT),
        "indexed_block": dt.create_indexed_block(2, [0, 5, 9], dt.SHORT),
        "struct": dt.create_struct([1, 2], [0, 8], [dt.INT, dt.DOUBLE]),
        "subarray_C": dt.create_subarray([4, 5], [2, 3], [1, 1], dt.INT),
        "subarray_F": dt.create_subarray([4, 5], [2, 3], [1, 1], dt.INT,
                                         "F"),
        "resized": dt.create_resized(dt.INT, -4, 16),
        "darray": dt.create_darray(4, 1, [6, 5], [dt.DISTRIBUTE_BLOCK,
                                                  dt.DISTRIBUTE_CYCLIC],
                                   [dt.DISTRIBUTE_DFLT_DARG, 2], [2, 2],
                                   dt.INT),
    }


def _envelope(t):
    comb, ints, aints, types_ = t.get_envelope()
    return comb, list(ints), list(aints), [x.name for x in types_]


def test_get_envelope_of_every_constructor():
    j, p = _types(JAX), _types(PORT)
    assert j.keys() == p.keys()
    for k in j:
        assert _envelope(j[k]) == _envelope(p[k]), k
        assert (j[k].spans.tobytes(), j[k].extent, j[k].lb, j[k].size) == \
            (p[k].spans.tobytes(), p[k].extent, p[k].lb, p[k].size), k
    assert _envelope(p["named"])[0] == "named"


@pytest.mark.parametrize("which", ["named", "vector", "struct", "darray"])
def test_datatype_attrs_across_dup(which):
    """``Datatype.dup`` keeps the typemap, names the original in its
    envelope and runs the keyvals' copy_fn; delete_fn fires on delete."""
    def one(lib):
        log = []
        t = _types(lib)[which]
        kv = lib.attr.Keyval(
            copy_fn=lambda o, k, e, v: (log.append(("copy", v)) or
                                        (True, v + [e])),
            delete_fn=lambda o, k, v, e: log.append(("delete", v)),
            extra=3)
        fresh = t.dup()
        had = fresh.attrs.get(kv)       # the lazy cache starts empty
        t.attrs.set(t, kv, [1])
        d = t.dup()
        got = d.attrs.get(kv)
        d.attrs.delete(d, kv)
        comb, _, _, types_ = d.get_envelope()
        t.attrs.delete(t, kv)
        return (had, got, comb, types_[0] is t, log,
                d.spans.tobytes(), d.extent, d.size, d.committed)
    j, p = one(JAX), one(PORT)
    assert j == p
    assert p[1] == (True, [1, 3]) and p[2] == "dup" and p[3]


DARRAY_CASES = [
    ("block", [8], ["BLOCK"], ["DFLT"], [4]),
    ("block_ragged", [10], ["BLOCK"], ["DFLT"], [4]),
    ("block_darg", [10], ["BLOCK"], [3], [4]),
    ("cyclic2", [11], ["CYCLIC"], [2], [3]),
    ("cyclic1", [7], ["CYCLIC"], ["DFLT"], [2]),
    ("none", [5, 6], ["NONE", "BLOCK"], ["DFLT", "DFLT"], [1, 3]),
    ("block_cyclic2", [6, 9], ["BLOCK", "CYCLIC"], ["DFLT", 2], [2, 3]),
    ("cyclic2_none_block", [5, 4, 6], ["CYCLIC", "NONE", "BLOCK"],
     [2, "DFLT", "DFLT"], [2, 1, 2]),
]


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("case,gsizes,dists,dargs,psizes", DARRAY_CASES,
                         ids=[c[0] for c in DARRAY_CASES])
@pytest.mark.parametrize("old", ["INT", "DOUBLE", "vector"])
def test_create_darray(case, gsizes, dists, dargs, psizes, order, old):
    """Every rank's darray: spans, extent, size and envelope bit for bit
    the JAX ones; the ranks' shares tile the global array once."""
    def one(lib):
        dt = lib.dt
        oldtype = dt.create_vector(2, 1, 2, dt.INT) if old == "vector" \
            else getattr(dt, old)
        ds = [getattr(dt, f"DISTRIBUTE_{d}") for d in dists]
        da = [dt.DISTRIBUTE_DFLT_DARG if a == "DFLT" else a for a in dargs]
        size = int(np.prod(psizes))
        out = []
        for r in range(size):
            t = dt.create_darray(size, r, gsizes, ds, da, psizes, oldtype,
                                 order)
            out.append((t.spans.tobytes(), t.extent, t.lb, t.size,
                        _envelope(t)[:3]))
        return out, oldtype.extent, oldtype.size
    j, (p, ext, osz) = one(JAX), one(PORT)
    assert j[0] == p
    total = int(np.prod(gsizes))
    assert sum(x[3] for x in p) == total * osz
    assert all(x[1] == total * ext for x in p)


def test_create_darray_errors():
    def one(lib):
        dt = lib.dt
        return [
            _code(lambda: dt.create_darray(4, 0, [8], [dt.DISTRIBUTE_BLOCK],
                                           [1], [4], dt.INT)),
            _code(lambda: dt.create_darray(4, 0, [8], [dt.DISTRIBUTE_NONE],
                                           [dt.DISTRIBUTE_DFLT_DARG], [4],
                                           dt.INT)),
            _code(lambda: dt.create_darray(3, 0, [8], [dt.DISTRIBUTE_BLOCK],
                                           [dt.DISTRIBUTE_DFLT_DARG], [4],
                                           dt.INT)),
            _code(lambda: dt.create_darray(4, 0, [8, 2],
                                           [dt.DISTRIBUTE_BLOCK],
                                           [dt.DISTRIBUTE_DFLT_DARG], [4],
                                           dt.INT)),
        ]
    assert one(JAX) == one(PORT) == [port_errors.MPI_ERR_ARG] * 4


def test_darray_moves_the_share(env):
    """A darray receive of a global 2-D array: each rank gets its block
    x cyclic(2) share of the root's array, as the JAX package's."""
    def app(comm, lib):
        dt = lib.dt
        t = dt.create_darray(comm.size, comm.rank, [4, 6],
                             [dt.DISTRIBUTE_BLOCK, dt.DISTRIBUTE_CYCLIC],
                             [dt.DISTRIBUTE_DFLT_DARG, 2], [2, 2],
                             dt.INT).commit()
        glob = np.arange(24, dtype=np.int32)
        if comm.rank == 0:
            for r in range(1, comm.size):
                comm.send(glob, r, tag=3)
            return None
        out = np.full(24, -1, np.int32)
        comm.recv(out, 0, tag=3)
        mine = np.full(24, -1, np.int32)
        t.unpack(t.pack(out, 1), mine, 1)
        return mine

    j, p = _both(4, app)
    assert_same(j, p)


# ---------------------------------------------------------------------------
# MPI_Info
# ---------------------------------------------------------------------------

def test_info():
    def one(lib):
        i = lib.info.Info({"wd": "/x"})
        i.set("path", "a:b")
        i.set("soft", "1:4")
        i.set("wd", "/y")
        d = i.dup()
        d.set("host", "h")
        i.delete("soft")
        i.delete("missing")
        return (i.nkeys, [i.nthkey(k) for k in range(i.nkeys)],
                i.get("wd"), i.get("soft"), d.nkeys,
                [d.nthkey(k) for k in range(d.nkeys)], sorted(d.items()),
                lib.info.INFO_NULL, lib.info.INFO_ENV.nkeys,
                lib.info.MAX_INFO_KEY, lib.info.MAX_INFO_VAL)
    assert one(JAX) == one(PORT)


def test_info_as_dict():
    i = port_info.Info({"wd": "/w", "path": "/p"})
    assert port_info.as_dict(i) == {"wd": "/w", "path": "/p"}
    assert port_info.as_dict({"wd": "/w"}) == {"wd": "/w"}
    assert port_info.as_dict(None) == {}


def test_info_in_spawn_ports_and_names(env):
    """The spawn, port and name-service calls take an Info where they
    take a dict."""
    svc = f"test-torch-attr-info-{time.monotonic_ns()}"
    hint = port_info.Info({"wd": "/tmp", "path": "/bin"})

    def child(cw):
        mpi.Comm_get_parent().barrier()

    def app(comm):
        inter, codes = mpi.Comm_spawn(child, maxprocs=1, comm=comm,
                                      info=hint)
        inter.barrier()
        port = None
        if comm.rank == 0:
            port = mpi.Open_port(info=hint)
            mpi.Publish_name(svc, port, info=hint)
        comm.barrier()
        found = mpi.Lookup_name(svc, info=hint)
        comm.barrier()
        if comm.rank == 0:
            mpi.Unpublish_name(svc, port, info=hint)
            mpi.Close_port(port)
        return codes, found == port if comm.rank == 0 else bool(found)

    got = run_ranks(2, app, device="cpu", timeout=TIMEOUT)
    assert got == [([0], True), ([0], True)]


# ---------------------------------------------------------------------------
# generalized requests
# ---------------------------------------------------------------------------

GREQ_DELAY_S = 0.05


def test_grequest_completed_from_a_thread(env):
    """A Grequest that another thread completes: ``waitall`` returns,
    query_fn filled the status, free_fn runs on free, and cancel after
    completion calls cancel_fn(True) and changes nothing."""
    def app(comm, lib):
        log = []

        def query(st):
            st.source, st.tag = comm.rank, 77
            log.append("query")
        start = (lib.req.grequest_start if lib.name == "jax"
                 else mpi.Grequest_start)
        g = start(query, lambda: log.append("free"),
                  lambda done: log.append(("cancel", done)))
        pending = g.test()
        timer = threading.Timer(GREQ_DELAY_S, g.complete)
        timer.start()
        sts = lib.req.waitall([g])
        timer.join(TIMEOUT)
        g.cancel()
        g.free()
        return (pending, g.complete_flag, sts[0].source, sts[0].tag,
                g.cancelled, g.status.cancelled, log)

    j, p = _both(2, app)
    assert_same(j, p)
    assert p[1] == (False, True, 1, 77, False, False,
                    ["query", ("cancel", True), "free"])


def test_grequest_cancel_before_completion(env):
    def app(comm, lib):
        log = []
        g = lib.req.grequest_start(None, None,
                                   lambda done: log.append(done))
        g.cancel()
        st = g.wait()
        return g.complete_flag, g.cancelled, st.cancelled, log

    j, p = _both(2, app)
    assert_same(j, p)
    assert p[0] == (True, True, True, [False])


def test_grequest_wakes_the_waiter(env):
    """A completion from another thread rings the rank engine's
    doorbell: the waiter, asleep in ``wait``, returns well under the run
    timeout, and the bell rang."""
    def app(comm):
        eng = comm.u.engine
        g = mpi.Grequest_start()
        tracked = g.req_id in eng.outstanding
        done = {}

        def finish():
            done["rings"] = eng.bell.rings
            done["t"] = time.perf_counter()
            g.complete()
        timer = threading.Timer(GREQ_DELAY_S, finish)
        timer.start()
        port_request.waitall([g])
        woke = time.perf_counter() - done["t"]
        timer.join(TIMEOUT)
        return (tracked, g.req_id in eng.outstanding,
                eng.bell.rings > done["rings"], woke)

    for tracked, still, rang, woke in run_ranks(2, app, device="cpu",
                                                timeout=TIMEOUT):
        assert tracked and not still and rang
        assert woke < 1.0, woke


def test_grequest_outside_a_rank():
    """With no universe the request has no engine: it completes in
    place."""
    g = port_request.grequest_start()
    g.complete()
    assert g.complete_flag and g.wait().cancelled is False


# ---------------------------------------------------------------------------
# create_group
# ---------------------------------------------------------------------------

def test_create_group_one_group(env):
    """The even ranks make a comm; the odd ranks return None at once and
    never join the agreement."""
    def app(comm, lib):
        evens = lib.group.Group([w for w in range(comm.size) if w % 2 == 0])
        if comm.rank % 2:
            return comm.create_group(evens, tag=11)
        g = comm.create_group(evens, tag=11)
        s = g.allreduce(np.array([comm.rank + 1, 2], np.int64))
        one = comm.create_group(lib.group.Group([comm.rank]), tag=12)
        return g.size, g.rank, s, one.size, one.allreduce(
            np.array([3], np.int64))

    j, p = _both(5, app)
    assert_same(j, p)
    assert p[1] is None and p[0][0] == 3


def test_create_group_two_disjoint_groups_at_once(env):
    """Evens and odds agree at the same time with the same tag: their
    ids may be equal, and their traffic never meets."""
    def app(comm, lib):
        mine = [w for w in range(comm.size) if w % 2 == comm.rank % 2]
        g = comm.create_group(lib.group.Group(mine), tag=3)
        out = [g.size, g.rank]
        for k in range(3):
            out.append(g.allreduce(np.array([comm.rank * 10 + k],
                                            np.int64)))
            out.append(g.bcast(np.array([comm.rank + k], np.int64), root=0))
        g.free()
        return out

    j, p = _both(6, app)
    assert_same(j, p)
    assert p[0][2].tolist() == [60] and p[1][2].tolist() == [90]


def test_create_group_threads_agree_at_once(env):
    """Two threads of each rank run create_group on two dups at once: the
    guarded payload makes one agreement retry, so the two new comms get
    distinct ids on every rank and their collectives stay apart."""
    def app(comm, lib):
        from mvapich2_tpu.runtime import universe as juni
        from mvapich2_tpu_torch.runtime import universe as puni
        uni = juni if lib.name == "jax" else puni
        u = uni.current_universe()
        d = [comm.dup(), comm.dup()]
        whole = lib.group.Group(list(range(comm.size)))
        made = [None, None]
        errs = []

        def agree(i):
            uni.set_universe(u)
            try:
                made[i] = d[i].create_group(whole, tag=20 + i)
            except BaseException as e:     # noqa: BLE001
                errs.append(e)
            finally:
                uni.set_universe(None)
        ts = [threading.Thread(target=agree, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(TIMEOUT)
        assert not errs and not any(t.is_alive() for t in ts), errs
        sums = [m.allreduce(np.array([comm.rank + 10 * i], np.int64))
                for i, m in enumerate(made)]
        return (made[0].context_id != made[1].context_id,
                [m.size for m in made], sums)

    j, p = _both(4, app, pvars=False)
    assert_same(j, p)
    assert all(r[0] for r in p)


def test_create_group_binds_a_channel(env):
    """On a run bound to a device (the CPU here) a group comm binds its
    channel by its members' geometry, and a tensor allreduce on it runs
    there."""
    import torch

    def app(comm):
        evens = port_group.Group([w for w in range(comm.size)
                                  if w % 2 == 0])
        g = comm.create_group(evens, tag=1)
        if g is None:
            return None
        out = g.allreduce(torch.full((16,), float(comm.rank)))
        return g.device_channel is not None, float(out[0])

    got = run_ranks(8, app, device="cpu", timeout=TIMEOUT)
    assert got[1::2] == [None] * 4
    assert got[0::2] == [(True, 12.0)] * 4
