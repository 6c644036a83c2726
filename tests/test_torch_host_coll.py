"""The port's host collective tier held against the JAX package on the
CPU: every algorithm of ``coll/tuning.py`` ``ALGOS`` under a forced
``<COLL>_ALGO`` at 1, 2, 3, 5 and 8 ranks, the tuned selection at sizes
on both sides of every table edge, the ops (MIN/MAX/PROD, logical,
bitwise, MINLOC/MAXLOC, a non-commutative user op), MPI_IN_PLACE, the
ragged v-variants, gather/scatter/scan/exscan/reduce_scatter, the
two-level allreduce over ``nodes=[0,0,0,0,1,1,1,1]``, the staging of
CPU tensors that the routing sends to the host tier, and the refusal of
tensors on the card there.

Each program runs through the JAX ``run_ranks`` (its host tier) and the
port's ``run_ranks(..., device="cpu")`` (COMM_WORLD bound to the slot
channel, whose wrappers send these calls to the host entries; the tuned
cases run on a ``dup``, whose numpy calls take the host tier in both
packages: the port's dup has a device channel for tensors only):
results equal bit for bit, and the ``coll_*_calls`` and ``pt2pt_*``
pvar deltas equal (``test_torch_pt2pt.run_both``). The data are seeded
random floats and integers: both packages fold the same numpy arrays in
the same order.
"""

import numpy as np
import pytest
import torch

from mvapich2_tpu.coll import tuning as jax_tuning

from mvapich2_tpu_torch import run_ranks
from mvapich2_tpu_torch.coll import tuning as port_tuning
from mvapich2_tpu_torch.core import datatype as port_dt
from mvapich2_tpu_torch.core import errors as port_errors

from test_torch_pt2pt import JAX, PORT, TIMEOUT, assert_same, env, run_both  # noqa: F401

NRANKS = [1, 2, 3, 5, 8]
# element counts of float32 on both sides of the tables' byte edges
# (1 KiB, 4 KiB, 8 KiB, 16 KiB, 32 KiB = SMP_EAGERSIZE, 64 KiB)
EDGE_COUNTS = [1, 256, 257, 1024, 1025, 2048, 2049, 4096, 4097, 8192,
               8193, 16384, 16385]


def _data(rank, n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed * 1000 + rank)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    return rng.integers(-1000, 1000, n).astype(dtype)


def test_algos_are_the_jax_tables():
    """The port registers every JAX algorithm but the network tier's
    (net2), and its tables are the JAX rows less the net2 class."""
    for coll, algos in jax_tuning.ALGOS.items():
        assert set(port_tuning.ALGOS[coll]) == set(algos) - {"net2"}
    for coll, classes in jax_tuning.DEFAULT_TABLES.items():
        assert port_tuning.DEFAULT_TABLES[coll] == {
            k: v for k, v in classes.items() if k != "net2"}


def _forced_cases():
    for coll, algos in port_tuning.ALGOS.items():
        for algo in algos:
            for n in NRANKS:
                yield coll, algo, n


def _forced_app(coll):
    def app(comm, lib):
        out = []
        r, p = comm.rank, comm.size
        if coll == "barrier":
            for _ in range(3):
                comm.barrier()
            return p
        if coll == "allreduce":
            for n in (1, 7, 1000, 4097, 20000):
                out.append(comm.allreduce(_data(r, n)))
                out.append(comm.allreduce(_data(r, n, np.int32),
                                          op=lib.op.MAX))
            return out
        if coll == "reduce":
            for n in (1, 7, 20000):
                for root in {0, p - 1}:
                    out.append(comm.reduce(_data(r, n), root=root))
            return out
        if coll == "bcast":
            for n in (1, 7, 5000, 70000):
                root = 2 % p
                buf = _data(r, n) if r == root else np.zeros(n, np.float32)
                comm.bcast(buf, root=root)
                out.append(buf)
            return out
        if coll == "allgather":
            for n in (1, 100, 9000):
                out.append(comm.allgather(_data(r, n, np.int32)))
            return out
        for n in (1, 64, 3000):     # alltoall
            out.append(comm.alltoall(_data(r, n * p, np.int32)))
        return out
    return app


@pytest.mark.parametrize("coll,algo,n", list(_forced_cases()))
def test_forced_algorithm(env, coll, algo, n):
    """Under ``<COLL>_ALGO=<algo>`` both packages run that host algorithm
    (counted by its ``coll_<coll>_<algo fn>_calls``) and give the same
    bits."""
    env(**{f"{coll.upper()}_ALGO": algo})
    j, p = run_both(n, _forced_app(coll))
    assert_same(j, p)


@pytest.mark.parametrize("coll", ["allreduce", "bcast", "allgather",
                                  "alltoall", "reduce", "barrier"])
@pytest.mark.parametrize("n", [3, 8, 9])
def test_tuned_selection_across_edges(env, coll, n):
    """Unforced, on a dup (numpy: the host tier in both packages): the
    same table bin, hence the same algorithm, on both sides of every
    edge of the small and flat2 classes."""
    def app(comm, lib):
        d = comm.dup()
        r = comm.rank
        out = []
        for cnt in EDGE_COUNTS:
            if coll == "allreduce":
                out.append(d.allreduce(_data(r, cnt)))
            elif coll == "reduce":
                out.append(d.reduce(_data(r, cnt), root=1))
            elif coll == "bcast":
                buf = _data(r, cnt) if r == 0 else np.zeros(cnt, np.float32)
                d.bcast(buf, root=0)
                out.append(buf)
            elif coll == "allgather":
                out.append(d.allgather(_data(r, max(1, cnt // d.size))))
            elif coll == "alltoall":
                k = max(1, cnt // d.size)
                out.append(d.alltoall(_data(r, k * d.size)))
            else:
                d.barrier()
        return out

    j, p = run_both(n, app)
    assert_same(j, p)


@pytest.mark.parametrize("op", ["SUM", "PROD", "MIN", "MAX", "LAND", "LOR",
                                "LXOR", "BAND", "BOR", "BXOR"])
def test_builtin_ops(env, op):
    """Each builtin op on allreduce, reduce and reduce_scatter_block in
    float32 (arithmetic and logical ops) and int32/uint8 (all)."""
    bitwise = op in ("BAND", "BOR", "BXOR")

    def app(comm, lib):
        o = getattr(lib.op, op)
        r, p = comm.rank, comm.size
        out = []
        dts = (np.int32, np.uint8) if bitwise else \
            (np.float32, np.int32, np.uint8)
        for dt in dts:
            x = _data(r, 50 * p, dt, seed=3)
            if op == "PROD" and np.dtype(dt).kind == "f":
                x = (x / 8 + 1).astype(dt)
            out.append(comm.allreduce(x, op=o))
            out.append(comm.reduce(x, op=o, root=p - 1))
            out.append(comm.reduce_scatter_block(x, op=o))
        return out

    j, p = run_both(5, app)
    assert_same(j, p)


def _loc_model(bufs, op):
    """MINLOC/MAXLOC over the ranks' item arrays: the smallest (largest)
    value, the lowest loc among equal values."""
    vals = np.stack([b["val"] for b in bufs])
    locs = np.stack([b["loc"] for b in bufs])
    best = vals.min(0) if op == "MINLOC" else vals.max(0)
    loc = np.where(vals == best, locs, np.iinfo(locs.dtype).max).min(0)
    return best, loc


def _check_loc_results(j, p, jt, basic, sig, bufs, count):
    """Each rank's MINLOC/MAXLOC items against the numpy model, whole,
    and against the JAX result's packed bytes, field by field."""
    for r in range(5):
        for k, opname in ((1, "MINLOC"), (2, "MAXLOC"), (3, "MINLOC")):
            got, ref = p[r][k], j[r][k]
            if k == 3 and r != 2:
                assert got is None and ref is None
                continue
            val, loc = _loc_model(bufs, opname)
            want = port_dt.packed_to_basic(np.zeros(count * sig, np.uint8),
                                           basic)
            want["val"], want["loc"] = val, loc
            assert got.dtype == basic and got.tobytes() == want.tobytes(), \
                (r, opname, got, want)
            # the JAX result's packed bytes are the reduced items' first
            # count * sig bytes: k whole items, whose padding the
            # two-level algorithms leave undefined, so fields compare
            whole = count * sig // basic.itemsize
            items = np.frombuffer(jt.pack(ref, count).tobytes(), np.uint8,
                                  count=whole * basic.itemsize).view(basic)
            for f in basic.names:
                assert items[f].tobytes() == got[:whole][f].tobytes(), \
                    (r, opname, f)


@pytest.mark.parametrize("pair", ["FLOAT_INT", "DOUBLE_INT", "TWOINT",
                                  "LONG_INT", "SHORT_INT"])
def test_minloc_maxloc(env, pair):
    """MINLOC/MAXLOC on the five pair types. The port restages each
    result item through ``packed_to_basic``: its values are the numpy
    model's and its padding (LONG_INT, DOUBLE_INT, SHORT_INT) is zero,
    so whole items compare bitwise, under the tuned selection and under
    a forced two-level allreduce (whose reduced items carry undefined
    padding). The JAX package scatters the reduced items' bytes as if
    they were packed: its result's packed signature bytes are the first
    ``count * sig`` bytes of the reduced items, whose fields the port's
    items must equal bitwise (all of them where an item has no
    padding)."""
    count = 16

    def app(comm, lib):
        t = getattr(lib.dt, pair)
        buf = np.zeros(count, dtype=t.basic)
        rng = np.random.default_rng(comm.rank)
        buf["val"] = rng.integers(0, 5, count)
        buf["loc"] = comm.rank
        return (buf,
                comm.allreduce(buf, op=lib.op.MINLOC, datatype=t,
                               count=count),
                comm.allreduce(buf, op=lib.op.MAXLOC, datatype=t,
                               count=count),
                comm.reduce(buf, op=lib.op.MINLOC, datatype=t, count=count,
                            root=2))

    j, p = run_both(5, app)
    env(ALLREDUCE_ALGO="two_level")
    j2, p2 = run_both(5, app)
    jt, pt = getattr(JAX.dt, pair), getattr(PORT.dt, pair)
    basic, sig = pt.basic, pt.size
    bufs = [r[0] for r in p]
    _check_loc_results(j, p, jt, basic, sig, bufs, count)
    _check_loc_results(j2, p2, jt, basic, sig, bufs, count)


def _matmul_op(lib):
    def f(invec, inout):
        a = invec.reshape(-1, 2, 2)
        b = inout.reshape(-1, 2, 2)
        return np.matmul(a, b).reshape(invec.shape)
    return lib.op.create_op(f, commute=False)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_noncommutative_user_op(env, n):
    """A 2x2 matrix product, order-sensitive: allreduce (gather_bcast),
    reduce (gather_local) at every root, scan, exscan and
    reduce_scatter_block fold in rank order, as in the JAX package."""
    def app(comm, lib):
        op = _matmul_op(lib)
        r, p = comm.rank, comm.size
        m = np.tile(np.array([1.0, r + 1, 0.0, 1.0]), 3) * (1 + r / 10)
        out = [comm.allreduce(m, op=op)]
        for root in range(p):
            out.append(comm.reduce(m, op=op, root=root))
        out.append(comm.scan(m, op=op))
        ex = np.zeros_like(m)
        comm.exscan(m, ex, op=op)
        out.append(ex if r else None)
        blk = np.tile(m[:4], p)
        out.append(comm.reduce_scatter_block(blk, op=op))
        return out

    j, p = run_both(n, app)
    assert_same(j, p)


def test_in_place(env):
    """MPI_IN_PLACE: allreduce, reduce at the root, allgather, alltoall,
    reduce_scatter_block, scan, exscan, gather at the root."""
    def app(comm, lib):
        r, p = comm.rank, comm.size
        IP = lib.IN_PLACE
        out = []
        b = _data(r, 300)
        comm.allreduce(IP, b)
        out.append(b)
        b = _data(r, 300)
        if r == 1:
            comm.reduce(IP, b, root=1)
        else:
            comm.reduce(b, None, root=1)
        out.append(b)
        g = np.zeros(4 * p, np.int32)
        g[r * 4:(r + 1) * 4] = r + 1
        comm.allgather(IP, g, count=4)   # the JAX call needs the count
        out.append(g)
        a = _data(r, 3 * p, np.int32)
        comm.alltoall(IP, a)
        out.append(a)
        rs = _data(r, 5 * p)
        res = np.zeros(5, np.float32)
        comm.reduce_scatter_block(rs, res)
        out.append(res)
        s = _data(r, 40)
        comm.scan(IP, s)
        out.append(s)
        gg = np.zeros(3 * p, np.int32)
        if r == 0:
            gg[:3] = 7
            comm.gather(IP, gg, root=0, count=3)
        else:
            comm.gather(np.full(3, r, np.int32), None, root=0)
        out.append(gg)
        return out

    j, p = run_both(5, app)
    assert_same(j, p)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_gather_scatter_scan(env, n):
    def app(comm, lib):
        r, p = comm.rank, comm.size
        out = []
        for root in sorted({0, p - 1}):
            out.append(comm.gather(_data(r, 13, np.int32), root=root))
            full = _data(r, 11 * p) if r == root else None
            mine = np.zeros(11, np.float32)
            comm.scatter(full, mine, root=root)
            out.append(mine)
        out.append(comm.scan(_data(r, 100)))
        out.append(comm.scan(_data(r, 100, np.int32), op=lib.op.MAX))
        ex = np.zeros(100, np.float32)
        comm.exscan(_data(r, 100), ex)
        out.append(ex if r else None)
        return out

    j, p = run_both(n, app)
    assert_same(j, p)


def _defined(buf, counts, displs):
    """The elements a v-collective defines (both packages leave
    uninitialized bytes in the gaps between displacements)."""
    return np.concatenate([buf[d:d + c] for c, d in zip(counts, displs)])


@pytest.mark.parametrize("n", [2, 5, 8])
def test_ragged_v_variants(env, n):
    """allgatherv, gatherv, scatterv, alltoallv and reduce_scatter with
    ragged counts, zero counts and spread displacements."""
    def app(comm, lib):
        r, p = comm.rank, comm.size
        counts = [(3 * k + 1) % 5 for k in range(p)]      # zeros included
        displs = [sum(counts[:k]) + 2 * k for k in range(p)]
        total = displs[-1] + counts[-1]
        out = []
        rb = np.full(total, -1, np.int32)
        comm.allgatherv(np.full(counts[r], r + 10, np.int32), rb, counts,
                        displs)
        out.append(_defined(rb, counts, displs))
        root = p - 1
        gb = np.full(total, -1, np.int32) if r == root else None
        comm.gatherv(np.full(counts[r], r + 20, np.int32), gb, counts,
                     displs, root=root)
        out.append(gb)
        mine = np.zeros(counts[r], np.int32)
        src = np.arange(total, dtype=np.int32) if r == root else None
        comm.scatterv(src, counts, displs, mine, root=root)
        out.append(mine)
        sc = [(r + k) % 3 for k in range(p)]
        rc = [(k + r) % 3 for k in range(p)]
        sd = [sum(sc[:k]) for k in range(p)]
        rd = [sum(rc[:k]) + k for k in range(p)]
        ab = np.full(rd[-1] + rc[-1], -1, np.float32)
        comm.alltoallv(_data(r, sum(sc)), sc, sd, ab, rc, rd)
        out.append(_defined(ab, rc, rd))
        rcounts = [k + 1 for k in range(p)]
        res = comm.reduce_scatter(_data(r, sum(rcounts)), counts=rcounts)
        out.append(res)
        return out

    j, p = run_both(n, app)
    assert_same(j, p)


def _gaps(buf, counts, displs):
    """The elements of ``buf`` that no receive range covers."""
    covered = np.zeros(len(buf), bool)
    for c, d in zip(counts, displs):
        covered[d:d + c] = True
    return buf[~covered]


SENTINEL = -12345


@pytest.mark.parametrize("on_dup", [False, True], ids=["world", "dup"])
@pytest.mark.parametrize("n", [2, 5, 8])
def test_v_gaps_keep_recvbuf(env, n, on_dup):
    """The blocking allgatherv and alltoallv write only their receive
    ranges: a sentinel in the gaps between spread displacements (and
    past the last range) survives on the port, in place and not, and
    the defined ranges are bitwise the JAX results."""
    def app(comm, lib):
        c = comm.dup() if on_dup else comm
        r, p = c.rank, c.size
        counts = [(3 * k + 1) % 5 for k in range(p)]      # zeros included
        displs = [sum(counts[:k]) + 2 * k + 1 for k in range(p)]
        total = displs[-1] + counts[-1] + 3
        out = []
        rb = np.full(total, SENTINEL, np.int32)
        c.allgatherv(np.full(counts[r], r + 10, np.int32), rb, counts,
                     displs)
        out.append(rb)
        ib = np.full(total, SENTINEL, np.int32)
        ib[displs[r]:displs[r] + counts[r]] = r + 30
        c.allgatherv(lib.IN_PLACE, ib, counts, displs)
        out.append(ib)
        sc = [(r + k) % 3 for k in range(p)]
        rc = [(k + r) % 3 for k in range(p)]
        sd = [sum(sc[:k]) for k in range(p)]
        rd = [sum(rc[:k]) + 2 * k for k in range(p)]
        ab = np.full(rd[-1] + rc[-1] + 2, SENTINEL, np.float32)
        c.alltoallv(_data(r, sum(sc)), sc, sd, ab, rc, rd)
        out.append(ab)
        return out, (counts, displs, rc, rd)

    j, p = run_both(n, app)
    for (jo, lay), (po, _) in zip(j, p):
        counts, displs, rc, rd = lay
        for k, (cnt, dsp) in enumerate(((counts, displs), (counts, displs),
                                        (rc, rd))):
            assert_same(_defined(jo[k], cnt, dsp), _defined(po[k], cnt, dsp))
            gaps = _gaps(po[k], cnt, dsp)
            assert gaps.size and np.all(gaps == SENTINEL), (k, po[k])


@pytest.mark.parametrize("algo", ["", "two_level", "rsa_arena",
                                  "two_level_slotted"])
def test_two_level_fake_nodes(env, algo):
    """8 ranks on two fake nodes: the tuned allreduce takes the two-level
    path from 4 KiB (shmem reduce, leader allreduce, shmem bcast), and
    the forced two-level algorithms run it at every size."""
    env(ALLREDUCE_ALGO=algo or None)

    def app(comm, lib):
        d = comm.dup()      # numpy on a dup: the tuned host selection
        out = []
        for cnt in (1, 1023, 1024, 5000, 40000):
            out.append(d.allreduce(_data(comm.rank, cnt)))
        return out

    j, p = run_both(8, app, nodes=[0, 0, 0, 0, 1, 1, 1, 1])
    assert_same(j, p)


def test_use_two_level_off(env):
    env(USE_TWO_LEVEL="0")

    def app(comm, lib):
        return comm.dup().allreduce(_data(comm.rank, 5000))

    j, p = run_both(8, app, nodes=[0, 0, 0, 0, 1, 1, 1, 1])
    assert_same(j, p)


def test_net2_class_raises_until_ported():
    """A host collective on 65 ranks is in the net2 class, whose tier is
    not ported: the table lookup says so."""
    class _Comm:
        size = 65
    with pytest.raises(NotImplementedError, match="netcoll"):
        port_tuning._lookup("allreduce", _Comm(), 4)


# ---------------------------------------------------------------------------
# routing and staging on a device-bound comm
# ---------------------------------------------------------------------------

def test_host_tier_calls_on_the_slot_channel(env):
    """What the JAX package keeps on its host tier runs there on the slot
    channel too: a numpy buffer below DEVICE_COLL_MIN_BYTES, float64,
    a user op, a forced host algorithm, USE_DEVICE_COLL off, and alltoallv
    (no slot transpose). A float64 CPU tensor is read as numpy and its
    result comes back as a tensor (one on the card raises:
    ``test_card_tensor_never_takes_the_host_tier``)."""
    from mvapich2_tpu_torch.ops import hbm

    def app(comm):
        r = comm.rank
        before = dict(hbm.PLAIN_CALLS)
        out = [comm.allreduce(_data(r, 4095)),
               comm.allreduce(_data(r, 100, np.float64)),
               comm.allreduce(_data(r, 64, np.int32),
                              op=PORT.op.create_op(np.add)),
               comm.reduce(_data(r, 9000), root=0)]
        c = [1] * comm.size
        out.append(comm.alltoallv(_data(r, comm.size), c, None, None, c,
                                  None))
        t = comm.allreduce(torch.from_numpy(_data(r, 100, np.float64)))
        out.append((type(t).__name__, t.dtype, t.numpy()))
        return out, {k: v - before.get(k, 0) for k, v in
                     hbm.PLAIN_CALLS.items()
                     if v - before.get(k, 0)}

    res = run_ranks(4, app, device="cpu", timeout=TIMEOUT)

    def rd4(n, dt=np.float32):
        # recursive doubling's fold of 4 ranks: (0+1)+(2+3) at every rank
        d = [_data(k, n, dt) for k in range(4)]
        return (d[0] + d[1]) + (d[2] + d[3])
    for r, (out, launched) in enumerate(res):
        assert out[0].tobytes() == rd4(4095).tobytes()
        assert out[1].tobytes() == rd4(100, np.float64).tobytes()
        assert out[5][0] == "Tensor" and out[5][1] == torch.float64
        assert out[5][2].tobytes() == out[1].tobytes()
        # reduce of 36000 bytes took the device (K1's plain version)
        assert launched.get("hbm_slot_allreduce", 0) > 0 or \
            launched.get("fused_reduce_to_slot", 0) > 0, launched


def test_tensor_staging_matches_jax(env):
    """On a comm with no device channel (a dup of a COMM_WORLD whose
    mesh, 3 devices under 4 ranks, binds none: a dup of a bound comm has
    a channel of its own) a CPU tensor is read as numpy for the
    collectives the JAX package stages a jax.Array in (allreduce, reduce,
    bcast, allgather, alltoall, reduce_scatter_block:
    ``_stage_if_unbound``), and refused with MPI_ERR_ARG by the others
    (gather here), as there; a tensor recvbuf is MPI_ERR_COMM."""
    import jax.numpy as jnp
    from mvapich2_tpu_torch import make_mesh

    def app(comm, lib):
        d = comm.dup()
        r = comm.rank
        x = _data(r, 8)
        dev = torch.from_numpy(x.copy()) if lib is PORT else jnp.asarray(x)
        out = [d.allreduce(dev), d.allgather(dev),
               d.reduce_scatter_block(dev), d.alltoall(dev)]
        out = [np.asarray(o) if not isinstance(o, np.ndarray) else o
               for o in out]
        errs = []
        with pytest.raises(lib.err.MPIException) as ei:
            d.gather(dev, root=0)
        errs.append(ei.value.error_class)
        d.barrier()
        with pytest.raises(lib.err.MPIException) as ei:
            d.allreduce(x, dev)
        errs.append(ei.value.error_class)
        return out, errs

    j, p = run_both(4, app, device_mesh=make_mesh((3,), ("x",), "cpu"))
    assert_same(j, p)
    assert p[0][1] == [port_errors.MPI_ERR_ARG, port_errors.MPI_ERR_COMM]


def _card(n, dtype=torch.float32):
    """A tensor that does not lie on the CPU: the meta device stands in
    for the card here (no data; the routing reads dtype and size only)."""
    return torch.empty(n, dtype=dtype, device="meta")


def _ints(rank, n, dtype=torch.float32):
    """Rank ``rank``'s seeded integer values in [-8, 8) as a CPU tensor
    (every bfloat16 sum of up to 16 of them is exact)."""
    x = np.random.default_rng(rank).integers(-8, 8, n).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _bf16_allreduce(c):
    got = c.allreduce(_ints(c.rank, 8192, torch.bfloat16))
    want = sum(_ints(k, 8192) for k in range(c.size)).to(torch.bfloat16)
    return got, want


def _fold_alltoall(c):
    p = c.size
    got = c.alltoall(torch.arange(2 * p, dtype=torch.float32) + 100 * c.rank)
    want = torch.tensor([100.0 * j + 2 * c.rank + e for j in range(p)
                         for e in range(2)])
    return got, want


def _slot_alltoallv(c):
    p, r = c.size, c.rank
    sc = [(r + j) % 3 for j in range(p)]
    rc = [(j + r) % 3 for j in range(p)]
    got = c.alltoallv(torch.arange(sum(sc), dtype=torch.float32) + 100 * r,
                      sc, None, None, rc, None)
    want = torch.tensor([100.0 * j + sum((j + m) % 3 for m in range(r)) + e
                         for j in range(p) for e in range(rc[j])])
    return got, want


def _dup_allreduce(c):
    got = c.dup().allreduce(_ints(c.rank, 64))
    return got, sum(_ints(k, 64) for k in range(c.size))


def _split_allgather(c):
    """Each parity's comm: a 1:1 channel over a 1-D mesh of 2."""
    got = c.split(c.rank % 2).allgather(_ints(c.rank, 64))
    return got, torch.cat([_ints(k, 64) for k in range(c.rank % 2, c.size,
                                                       2)])


def _slot_iallreduce(c):
    out = torch.zeros(64)
    c.iallreduce(_ints(c.rank, 64), out).wait()
    return out, sum(_ints(k, 64) for k in range(c.size))


_MESH4 = ((4,), ("x",))
_FOLD4 = ((2,), ("x",))
# (case, mesh geometry or None for the slot channel, env, the call on a
# rank's comm, what the error names; or, for a call that now has a
# device path, None and the kernel whose plain version it runs once, or
# (kernel, calls), the call returning (result, expected))
_CARD_CASES = [
    ("bf16", _MESH4, {}, _bf16_allreduce, None, "ring_all_reduce"),
    ("bf16_forced_device", _MESH4, {"ALLREDUCE_ALGO": "device"},
     _bf16_allreduce, None, "ring_all_reduce"),
    ("f64", None, {}, lambda c: c.allreduce(_card(64, torch.float64)),
     "float64", None),
    ("complex_bcast", None, {},
     lambda c: c.bcast(_card(64, torch.complex64)), "complex64", None),
    ("user_op", _MESH4, {}, lambda c: c.allreduce(
        _card(64), op=PORT.op.create_op(np.add)), "no device reduction",
     None),
    ("forced_host_algo", _MESH4, {"ALLREDUCE_ALGO": "ring"},
     lambda c: c.allreduce(_card(64)), "'ring' forced", None),
    ("device_coll_off", _MESH4, {"USE_DEVICE_COLL": 0},
     lambda c: c.reduce_scatter_block(_card(64)), "USE_DEVICE_COLL", None),
    ("fold_alltoall", _FOLD4, {}, _fold_alltoall, None, "hbm_alltoall"),
    ("slot_alltoallv", None, {}, _slot_alltoallv, None, "hbm_alltoallv"),
    ("alltoallv_in_place", _MESH4, {}, lambda c: c.alltoallv(
        PORT.IN_PLACE, [1] * 4, None, _card(4), [1] * 4, None),
     "MPI_IN_PLACE", None),
    ("dup", None, {}, _dup_allreduce, None, "fused_reduce_to_slot"),
    ("split", _MESH4, {}, _split_allgather, None, ("ring_all_gather", 2)),
    ("slot_iallreduce", None, {}, _slot_iallreduce, None,
     "fused_reduce_to_slot"),
]


@pytest.mark.parametrize("case,geom,cvars,call,names,kernel", _CARD_CASES,
                         ids=[c[0] for c in _CARD_CASES])
def test_card_tensor_never_takes_the_host_tier(env, case, geom, cvars,
                                               call, names, kernel):
    """A tensor on the card never goes to the host tier. A call that the
    device tier cannot take (a dtype or op that does not lower; a forced
    host algorithm; USE_DEVICE_COLL off; MPI_IN_PLACE alltoallv)
    raises NotImplementedError naming why, on every rank, before any
    data moves. The calls that have a device path for a tensor
    (bfloat16 on the mesh channel, forced or not; alltoall on the fold
    channel; alltoallv on the slot channel; an allreduce on a dup of the
    slot channel's comm, which gets a slot channel of its own; an
    allgather on each parity's split of a 1:1 mesh of 4, a 1:1 channel
    over a mesh of 2; an iallreduce into a tensor on the slot channel,
    on its device NBC tier) run it on CPU tensors: the result is exact
    and the kernel's plain version ran once a comm, with
    dev_coll_fallback_dtype unmoved. Either way no tensor is staged to
    the host (``to_host`` raises while the calls run)."""
    from mvapich2_tpu_torch import make_mesh, mpit
    from mvapich2_tpu_torch.coll import device as port_device
    from mvapich2_tpu_torch.ops import alltoall, hbm, ici, ring
    env(**cvars)

    def refused(comm):
        with pytest.raises(NotImplementedError, match=names) as ei:
            call(comm)
        comm.barrier()
        return str(ei.value)

    def routed(comm):
        got, want = call(comm)
        return got.dtype == want.dtype and torch.equal(got, want)

    real = port_device.to_host

    def no_staging(t):
        raise AssertionError("a tensor on the card was staged")
    for m in (alltoall, hbm, ici, ring):
        m.reset_counts()
    fallback = mpit.pvar("dev_coll_fallback_dtype").read()
    port_device.to_host = no_staging
    try:
        mesh = make_mesh(*geom, "cpu") if geom else None
        got = run_ranks(4, refused if names else routed, device="cpu",
                        device_mesh=mesh, timeout=TIMEOUT)
    finally:
        port_device.to_host = real
    if names:
        assert all("is not moved to the host" in g for g in got), got
        return
    assert got == [True] * 4
    plain = {**ring.PLAIN_CALLS, **ici.PLAIN_CALLS, **alltoall.PLAIN_CALLS,
             **hbm.PLAIN_CALLS}
    want = dict([kernel]) if isinstance(kernel, tuple) else {kernel: 1}
    assert {k: v for k, v in plain.items() if v} == want, plain
    assert mpit.pvar("dev_coll_fallback_dtype").read() == fallback


def test_jax_segment_path_same_values():
    """Unpatched, the JAX package's thread ranks move large allreduces
    and bcasts through a shared-memory segment (its sectioned exchange),
    where the port runs the point-to-point two-level and scatter-ring
    branches: on integer-valued data the values are the same bits."""
    def app(comm, lib):
        d = comm.dup()
        r = comm.rank
        x = np.round(_data(r, 30000) * 100)
        buf = x.copy() if r == 1 else np.zeros_like(x)
        d.bcast(buf, root=1)
        out = d.allreduce(x), d.allreduce(x.astype(np.int32)), buf
        d.free()        # the JAX package unlinks its segment here
        return out

    j, p = run_both(5, app, pvars=False)
    assert_same(j, p)
