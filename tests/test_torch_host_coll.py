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
cases run on a ``dup``, which has no device channel in either package):
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
    """Unforced, on a dup (no device channel in either package): the
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


@pytest.mark.parametrize("pair", ["FLOAT_INT", "DOUBLE_INT", "TWOINT",
                                  "LONG_INT", "SHORT_INT"])
def test_minloc_maxloc(env, pair):
    def app(comm, lib):
        t = getattr(lib.dt, pair)
        buf = np.zeros(16, dtype=t.basic)
        rng = np.random.default_rng(comm.rank)
        buf["val"] = rng.integers(0, 5, 16)
        buf["loc"] = comm.rank
        return (comm.allreduce(buf, op=lib.op.MINLOC, datatype=t,
                               count=16),
                comm.allreduce(buf, op=lib.op.MAXLOC, datatype=t, count=16),
                comm.reduce(buf, op=lib.op.MINLOC, datatype=t, count=16,
                            root=2))

    j, p = run_both(5, app)
    assert_same(j, p)


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


@pytest.mark.parametrize("algo", ["", "two_level", "rsa_arena",
                                  "two_level_slotted"])
def test_two_level_fake_nodes(env, algo):
    """8 ranks on two fake nodes: the tuned allreduce takes the two-level
    path from 4 KiB (shmem reduce, leader allreduce, shmem bcast), and
    the forced two-level algorithms run it at every size."""
    env(ALLREDUCE_ALGO=algo or None)

    def app(comm, lib):
        d = comm.dup()      # no device channel: the tuned host selection
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
    """On a comm with no device channel (a dup) a CPU tensor is read as
    numpy for the collectives the JAX package stages a jax.Array in
    (allreduce, reduce, bcast, allgather, alltoall, reduce_scatter_block:
    ``_stage_if_unbound``), and refused with MPI_ERR_ARG by the others
    (gather here), as there; a tensor recvbuf is MPI_ERR_COMM."""
    import jax.numpy as jnp

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

    j, p = run_both(4, app)
    assert_same(j, p)
    assert p[0][1] == [port_errors.MPI_ERR_ARG, port_errors.MPI_ERR_COMM]


def _card(n, dtype=torch.float32):
    """A tensor that does not lie on the CPU: the meta device stands in
    for the card here (no data; the routing reads dtype and size only)."""
    return torch.empty(n, dtype=dtype, device="meta")


_MESH4 = ((4,), ("x",))
_FOLD4 = ((2,), ("x",))
# (case, mesh geometry or None for the slot channel, env, the call on a
# rank's comm, what the error names)
_CARD_CASES = [
    ("bf16", _MESH4, {}, lambda c: c.allreduce(_card(8192, torch.bfloat16)),
     "bfloat16"),
    ("bf16_forced_device", _MESH4, {"ALLREDUCE_ALGO": "device"},
     lambda c: c.allreduce(_card(8192, torch.bfloat16)), "bfloat16"),
    ("f64", None, {}, lambda c: c.allreduce(_card(64, torch.float64)),
     "float64"),
    ("complex_bcast", None, {},
     lambda c: c.bcast(_card(64, torch.complex64)), "complex64"),
    ("user_op", _MESH4, {}, lambda c: c.allreduce(
        _card(64), op=PORT.op.create_op(np.add)), "no device reduction"),
    ("forced_host_algo", _MESH4, {"ALLREDUCE_ALGO": "ring"},
     lambda c: c.allreduce(_card(64)), "'ring' forced"),
    ("device_coll_off", _MESH4, {"USE_DEVICE_COLL": 0},
     lambda c: c.reduce_scatter_block(_card(64)), "USE_DEVICE_COLL"),
    ("fold_alltoall", _FOLD4, {}, lambda c: c.alltoall(_card(64)),
     "fold channel"),
    ("slot_alltoallv", None, {}, lambda c: c.alltoallv(
        _card(4), [1] * 4, None, None, [1] * 4, None), "slot channel"),
    ("alltoallv_in_place", _MESH4, {}, lambda c: c.alltoallv(
        PORT.IN_PLACE, [1] * 4, None, _card(4), [1] * 4, None),
     "MPI_IN_PLACE"),
    ("dup", None, {}, lambda c: c.dup().allreduce(_card(64)),
     "no device channel"),
    ("split", _MESH4, {}, lambda c: c.split(c.rank % 2).allgather(
        _card(64)), "no device channel"),
    ("slot_iallreduce", None, {}, lambda c: c.iallreduce(
        _card(64), _card(64)), "NBC tier"),
]


@pytest.mark.parametrize("case,geom,cvars,call,names", _CARD_CASES,
                         ids=[c[0] for c in _CARD_CASES])
def test_card_tensor_never_takes_the_host_tier(env, case, geom, cvars,
                                               call, names):
    """A tensor that lies on the card and a call that the device tier
    cannot take (a dtype or op that does not lower, bfloat16 among them
    as in the JAX package; a forced host algorithm; USE_DEVICE_COLL off;
    a collective the channel does not run; MPI_IN_PLACE alltoallv; a
    comm with no device channel; an i-call the NBC tier refuses) raise
    NotImplementedError naming why, on every rank, before any data
    moves: the host tier never copies such a tensor to the host and
    back."""
    from mvapich2_tpu_torch import make_mesh
    from mvapich2_tpu_torch.coll import device as port_device
    env(**cvars)

    def app(comm):
        with pytest.raises(NotImplementedError, match=names) as ei:
            call(comm)
        comm.barrier()
        return str(ei.value)

    real = port_device.to_host

    def no_staging(t):
        raise AssertionError("a tensor on the card was staged")
    port_device.to_host = no_staging
    try:
        mesh = make_mesh(*geom, "cpu") if geom else None
        got = run_ranks(4, app, device="cpu", device_mesh=mesh,
                        timeout=TIMEOUT)
    finally:
        port_device.to_host = real
    assert all("is not moved to the host" in g for g in got), got


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
