"""The port's process topologies and neighborhood collectives
(``core/topo.py``) held against the JAX package on the CPU.

The cases are those of ``tests/test_topo.py``: one program runs through
the JAX ``run_ranks`` and the port's ``run_ranks(..., device="cpu")``
on the same seeded integer-valued inputs, and every index, topology and
data result is equal bit for bit, as are the pt2pt and coll_*_calls
pvar deltas (``test_torch_pt2pt.run_both``). Covered: dims_create, the
coordinate and rank round trip, shift (periodic and not), sub (rows and
all dims dropped), graph, dist-graph (adjacent and general, weighted),
the three neighbor collectives (PROC_NULL neighbors, duplicate peers,
empty and oversized buffers, a strided ``recvbuf``), a cart of fewer
ranks, ``cart_map``, ``topo`` carried by ``dup`` and the error codes.
Then what only the port has: a CPU tensor read and written in place, a
tensor on the card refused by each neighbor collective on every rank
and never staged to the host, and the device channels that topology
comms bind. Every ``run_ranks`` takes the shared 30 s timeout.
"""

import types

import numpy as np
import pytest
import torch

from mvapich2_tpu.core import errors as jax_errors
from mvapich2_tpu.core import status as jax_status
from mvapich2_tpu.core import topo as jax_topo

from mvapich2_tpu_torch import run_ranks
from mvapich2_tpu_torch.core import errors as port_errors
from mvapich2_tpu_torch.core import status as port_status
from mvapich2_tpu_torch.core import topo as port_topo

from test_torch_pt2pt import TIMEOUT, assert_same, env, run_both  # noqa: F401

JAX = types.SimpleNamespace(name="jax", topo=jax_topo, st=jax_status,
                            err=jax_errors)
PORT = types.SimpleNamespace(name="port", topo=port_topo, st=port_status,
                             err=port_errors)


def _both(n, app):
    """``app(comm, lib)`` with ``lib`` the package's topo namespace."""
    def run(comm, lib):
        return app(comm, JAX if lib.name == "jax" else PORT)
    return run_both(n, run)


def _code(fn):
    """The MPI error class ``fn()`` raises (None if it returns)."""
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - both packages' classes
        return getattr(e, "error_class", type(e).__name__)
    return None


def _vals(seed, rank, n, dtype=np.int64):
    rng = np.random.default_rng(seed * 7919 + rank)
    return rng.integers(-1000, 1000, n).astype(dtype)


# ---------------------------------------------------------------------------
# without ranks: dims_create and the Cartesian arithmetic
# ---------------------------------------------------------------------------

DIMS_CASES = [(12, 2, None), (8, 3, None), (7, 1, None), (6, 2, [3, 0]),
              (1, 2, None), (24, 3, [0, 2, 0]), (360, 4, None),
              (16, 2, [4, 4]), (7, 2, [2, 0]), (6, 2, [4, 4]),
              (6, 2, [-1, 0]), (6, 3, [0, 0])]


@pytest.mark.parametrize("nnodes,ndims,dims", DIMS_CASES)
def test_dims_create(nnodes, ndims, dims):
    """The factorization, or MPI_ERR_DIMS for dims that cannot cover
    ``nnodes``."""
    def one(lib):
        try:
            return lib.topo.dims_create(nnodes, ndims, dims)
        except lib.err.MPIException as e:
            return ("error", e.error_class)
    got = one(PORT)
    assert one(JAX) == got
    if got[0] == "error":
        assert got[1] == port_errors.MPI_ERR_DIMS


@pytest.mark.parametrize("dims,periods", [
    ([2, 3, 4], [True, False, True]), ([5], [False]), ([3, 3], [True, True]),
    ([1, 4, 2], [False, True, False])])
def test_cart_coords_rank_roundtrip(dims, periods):
    def one(lib):
        t = lib.topo.CartTopology(dims, periods)
        n = t.nnodes()
        coords = [t.coords_of(r) for r in range(n)]
        back = [t.rank_of(c) for c in coords]
        edges = [t.rank_of([d if i == k else 0 for i in range(len(dims))])
                 for k, d in enumerate(dims)]
        under = [t.rank_of([-1 if i == k else 0 for i in range(len(dims))])
                 for k in range(len(dims))]
        nbrs = [t.neighbors_of(r) for r in range(n)]
        return coords, back, edges, under, nbrs, _code(
            lambda: t.coords_of(n))
    j, p = one(JAX), one(PORT)
    assert_same(j, p)
    assert p[1] == list(range(len(p[0])))
    assert p[5] == port_errors.MPI_ERR_RANK


# ---------------------------------------------------------------------------
# constructors and accessors on ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
@pytest.mark.parametrize("n", [2, 4, 5])
def test_cart_shift(env, n, periodic):
    """A 1-D cart: shift by 1 and 2 and its sendrecv (PROC_NULL peers at
    open edges still complete, their receive untouched)."""
    def app(comm, lib):
        cart = comm.cart_create([comm.size], periods=[periodic])
        out = [cart.topo_test(), cart.cart_shift(0, 1), cart.cart_shift(0, 2),
               cart.cart_shift(0, -1), cart.cartdim_get(), cart.cart_get()]
        src, dst = out[1]
        buf = np.array([cart.rank * 7 + 1], dtype=np.int64)
        got = np.full(1, -1, dtype=np.int64)
        cart.sendrecv(buf, dst, 0, got, src, 0)
        out.append(got)
        return out

    j, p = _both(n, app)
    assert_same(j, p)
    if periodic:
        assert p[0][1] == ((n - 1) % n, 1 % n)
    else:
        assert p[0][1][0] == port_status.PROC_NULL


def test_cart_2d_sub(env):
    """(2, 3) and (2, 2, 2) carts: cart_get, coords and ranks, and the
    rows of cart_sub with their allgather; all dims dropped leaves rank 0
    a zero-dim comm and the rest None."""
    def app(comm, lib):
        out = []
        for dims in ([2, 3], [2, 2, 2]):
            cart = comm.cart_create(dims, periods=[False] * len(dims))
            if cart is None:
                out.append(None)
                continue
            dims_, periods, coords = cart.cart_get()
            rows = []
            for remain in ([False, True] + [False] * (len(dims) - 2),
                           [True] + [False] * (len(dims) - 1),
                           [True] * (len(dims) - 1) + [False]):
                row = cart.cart_sub(remain)
                got = np.zeros(row.size, dtype=np.int64)
                row.allgather(np.array([cart.rank * 10 + row.rank],
                                       dtype=np.int64), got, count=1)
                rows.append((row.size, row.rank, row.topo_test(),
                             row.cart_get(), got))
            none = cart.cart_sub([False] * len(dims))
            out.append((dims_, periods, coords, cart.cart_coords(0),
                        cart.cart_rank(coords), rows,
                        None if none is None else
                        (none.size, none.cartdim_get())))
        return out

    j, p = _both(8, app)
    assert_same(j, p)


def test_graph_create(env):
    """A ring graph over 4 of 5 ranks: neighbors, topo_test, and None on
    the rank left out."""
    def app(comm, lib):
        g = comm.graph_create([2, 4, 6, 8], [1, 3, 0, 2, 1, 3, 2, 0])
        if g is None:
            return None
        return (g.graph_neighbors(), g.graph_neighbors(0), g.topo_test(),
                g.size, g.rank)

    j, p = _both(5, app)
    assert_same(j, p)
    assert p[4] is None and p[1][2] == "graph"


def test_dist_graph_adjacent(env):
    def app(comm, lib):
        left = (comm.rank - 1) % comm.size
        right = (comm.rank + 1) % comm.size
        dg = comm.dist_graph_create_adjacent([left, right], [right],
                                             sweights=[3, 4], dweights=[5])
        t = dg.topo
        return (dg.dist_graph_neighbors(), dg.topo_test(), t.sweights,
                t.dweights, t.weighted, dg.graph_neighbors())

    j, p = _both(4, app)
    assert_same(j, p)


@pytest.mark.parametrize("weighted", [False, True])
def test_dist_graph_general(env, weighted):
    """Each rank declares its own out-edges and one edge of another
    rank: the allgather of counts and the allgatherv of the weighted
    triples give every rank its in- and out-neighbors and weights."""
    def app(comm, lib):
        r, n = comm.rank, comm.size
        sources = [r, (r + 2) % n]
        degrees = [2, 1]
        dests = [(r + 1) % n, (r + 3) % n, r]
        weights = [10 * r + k for k in range(3)] if weighted else None
        dg = comm.dist_graph_create(sources, degrees, dests, weights)
        t = dg.topo
        return (dg.dist_graph_neighbors(), t.sweights, t.dweights,
                t.weighted)

    j, p = _both(5, app)
    assert_same(j, p)


def test_dist_graph_general_no_edges(env):
    def app(comm, lib):
        dg = comm.dist_graph_create([], [], [])
        return dg.dist_graph_neighbors(), dg.topo.weighted

    j, p = _both(3, app)
    assert_same(j, p)


def test_cart_create_fewer_ranks(env):
    """A cart of 2 over 4 ranks: None on the ranks left out, whose
    context ids go back (a later dup on every rank agrees)."""
    def app(comm, lib):
        cart = comm.cart_create([2], periods=[False])
        d = comm.dup()
        s = d.allreduce(np.array([comm.rank + 1], np.int64))
        if cart is None:
            return None, s
        return (cart.size, cart.rank, cart.cart_shift(0, 1)), s

    j, p = _both(4, app)
    assert_same(j, p)
    assert p[2][0] is None and p[3][0] is None


def test_cart_map(env):
    def app(comm, lib):
        return (lib.topo.cart_map(comm, [2, 2], [True, False]),
                lib.topo.cart_map(comm, [3], [False]))

    j, p = _both(4, app)
    assert_same(j, p)
    assert p[3][1] == port_status.UNDEFINED


def test_dup_carries_topo(env):
    """``dup`` carries the topology: the dup's shift and neighbor
    exchange equal the cart's."""
    def app(comm, lib):
        cart = comm.cart_create([2, 2], periods=[True, False])
        d = cart.dup()
        rb = np.full(4, -1, dtype=np.int64)
        d.neighbor_allgather(np.array([cart.rank + 50], np.int64), rb,
                             count=1)
        return (d.topo_test(), d.cart_shift(1, 1) == cart.cart_shift(1, 1),
                d.cart_get(), rb)

    j, p = _both(4, app)
    assert_same(j, p)


# ---------------------------------------------------------------------------
# neighborhood collectives
# ---------------------------------------------------------------------------

def _ring(comm):
    return (comm.rank - 1) % comm.size, (comm.rank + 1) % comm.size


def _case_allgather_ring(comm, lib):
    cart = comm.cart_create([comm.size], periods=[True])
    rb = np.zeros(2, dtype=np.int64)
    cart.neighbor_allgather(np.array([cart.rank + 100], np.int64), rb,
                            count=1)
    return rb


def _case_allgather_halo_2d(comm, lib):
    """The stencil halo skeleton on a 2 x 2 torus (4 neighbors)."""
    cart = comm.cart_create([2, 2], periods=[True, True])
    halo = np.zeros((4, 4), dtype=np.float64)
    cart.neighbor_allgather(_vals(1, cart.rank, 4).astype(np.float64),
                            halo, count=4)
    return halo, cart.topo.neighbors_of(cart.rank)


def _case_alltoall_dist_graph(comm, lib):
    left, right = _ring(comm)
    dg = comm.dist_graph_create_adjacent([left, right], [left, right])
    rb = np.zeros(6, dtype=np.int64)
    dg.neighbor_alltoall(_vals(2, comm.rank, 6), rb, count=3)
    return rb


def _case_alltoall_inferred_count(comm, lib):
    left, right = _ring(comm)
    dg = comm.dist_graph_create_adjacent([right, left], [left, right])
    rb = np.zeros(8, dtype=np.int32)
    dg.neighbor_alltoall(_vals(3, comm.rank, 8, np.int32), rb)
    return rb


def _case_alltoallv(comm, lib):
    left, right = _ring(comm)
    dg = comm.dist_graph_create_adjacent([left, right], [left, right])
    sbuf = _vals(4, comm.rank, 3)
    rbuf = np.full(4, -7, dtype=np.int64)
    dg.neighbor_alltoallv(sbuf, [1, 2], [0, 1], rbuf, [2, 1], [0, 3])
    return rbuf


def _case_alltoallv_zero_counts(comm, lib):
    left, right = _ring(comm)
    dg = comm.dist_graph_create_adjacent([left, right], [left, right])
    sbuf = _vals(5, comm.rank, 2)
    rbuf = np.full(3, -7, dtype=np.int64)
    dg.neighbor_alltoallv(sbuf, [0, 2], [0, 0], rbuf, [2, 0], [1, 0])
    return rbuf


def _case_proc_null(comm, lib):
    """An open 1-D and (2, 3) cart: a PROC_NULL neighbor's block keeps
    its sentinel in all three collectives."""
    out = []
    line = comm.cart_create([comm.size], periods=[False])
    rb = np.full(2, -9, dtype=np.int64)
    line.neighbor_allgather(np.array([line.rank], np.int64), rb, count=1)
    out.append(rb)
    rb = np.full(4, -9, dtype=np.int64)
    line.neighbor_alltoall(_vals(6, line.rank, 4), rb, count=2)
    out.append(rb)
    rb = np.full(3, -9, dtype=np.int64)
    line.neighbor_alltoallv(_vals(7, line.rank, 3), [1, 2], [0, 1], rb,
                            [2, 1], [0, 2])
    out.append(rb)
    grid = comm.cart_create([2, 3], periods=[False, False])
    if grid is not None:
        rb = np.full(8, -9, dtype=np.int64)
        grid.neighbor_alltoall(_vals(8, grid.rank, 8), rb, count=2)
        out.append(rb)
    return out


def _case_duplicate_peer(comm, lib):
    """2 ranks, periodic: left == right, matched in post order."""
    cart = comm.cart_create([2], periods=[True])
    rb = np.full(2, -1, dtype=np.int64)
    cart.neighbor_alltoall(np.array([cart.rank * 10, cart.rank * 10 + 1],
                                    np.int64), rb, count=1)
    ab = np.full(2, -1, dtype=np.int64)
    cart.neighbor_allgather(np.array([cart.rank + 5], np.int64), ab, count=1)
    vb = np.full(3, -1, dtype=np.int64)
    cart.neighbor_alltoallv(_vals(9, cart.rank, 3), [1, 2], [0, 1], vb,
                            [1, 2], [0, 1])
    return rb, ab, vb


def _case_empty_and_oversized(comm, lib):
    dg = comm.dist_graph_create_adjacent([], [])
    e = np.empty(0, np.int64)
    dg.neighbor_alltoall(e, np.empty(0, np.int64), count=1)
    dg.neighbor_allgather(e, np.empty(0, np.int64), count=0)
    dg.neighbor_alltoallv(e, [], [], np.empty(0, np.int64), [], [])
    left, right = _ring(comm)
    dg2 = comm.dist_graph_create_adjacent([left, right], [left, right])
    rb = np.full(8, -1, dtype=np.int64)
    dg2.neighbor_allgather(np.array([comm.rank], np.int64), rb, count=1)
    return rb


def _case_strided_recvbuf(comm, lib):
    """A strided ``recvbuf`` (every other column) is written back; the
    columns between keep their values."""
    cart = comm.cart_create([comm.size], periods=[True])
    full = np.full((2, 6), -3, dtype=np.int64)
    view = full[:, ::2]
    cart.neighbor_allgather(_vals(10, cart.rank, 3), view, count=3)
    full2 = np.full((4, 4), -3, dtype=np.int64)
    cart.neighbor_alltoall(_vals(11, cart.rank, 4), full2[::2, 1:3],
                           count=2)
    full3 = np.full(10, -3, dtype=np.int64)
    cart.neighbor_alltoallv(_vals(12, cart.rank, 3), [1, 2], [0, 1],
                            full3[::2], [2, 1], [0, 3])
    return full, full2, full3


def _case_float_dtypes(comm, lib):
    left, right = _ring(comm)
    dg = comm.dist_graph_create_adjacent([left, right], [right, left])
    out = []
    for dt in (np.float32, np.int16, np.uint8):
        rb = np.zeros(4, dtype=dt)
        dg.neighbor_alltoall(_vals(13, comm.rank, 4).astype(dt), rb,
                             count=2)
        out.append(rb)
    return out


NEIGHBOR_CASES = [
    ("allgather_ring", _case_allgather_ring, 4),
    ("allgather_halo_2d", _case_allgather_halo_2d, 4),
    ("alltoall_dist_graph", _case_alltoall_dist_graph, 4),
    ("alltoall_inferred_count", _case_alltoall_inferred_count, 3),
    ("alltoallv", _case_alltoallv, 4),
    ("alltoallv_zero_counts", _case_alltoallv_zero_counts, 5),
    ("proc_null", _case_proc_null, 6),
    ("duplicate_peer_2rank_ring", _case_duplicate_peer, 2),
    ("empty_and_oversized", _case_empty_and_oversized, 4),
    ("strided_recvbuf", _case_strided_recvbuf, 4),
    ("dtypes", _case_float_dtypes, 3),
]


@pytest.mark.parametrize("case,app,n", NEIGHBOR_CASES,
                         ids=[c[0] for c in NEIGHBOR_CASES])
def test_neighbor_collectives(env, case, app, n):
    j, p = _both(n, app)
    assert_same(j, p)


def test_neighbor_duplicate_peer_order(env):
    """The oracle of ``tests/test_topo.py``: recv slot k gets the peer's
    k-th send block."""
    def app(comm, lib):
        return _case_duplicate_peer(comm, lib)[0]

    j, p = _both(2, app)
    assert_same(j, p)
    assert p[0].tolist() == [10, 11] and p[1].tolist() == [0, 1]


# ---------------------------------------------------------------------------
# error codes
# ---------------------------------------------------------------------------

def test_error_codes(env):
    def app(comm, lib):
        cart = comm.cart_create([2, 2], periods=[False, False])
        left, right = _ring(comm)
        dg = comm.dist_graph_create_adjacent([left], [right])
        small = np.zeros(1, np.int64)
        return [
            _code(lambda: comm.cart_shift(0, 1)),          # no topology
            _code(lambda: comm.cart_get()),
            _code(lambda: comm.graph_neighbors()),
            _code(lambda: comm.neighbor_allgather(small, small, count=1)),
            _code(lambda: dg.cart_coords()),
            _code(lambda: comm.dist_graph_neighbors()),
            _code(lambda: cart.cart_shift(2, 1)),           # bad direction
            _code(lambda: cart.cart_coords(9)),
            _code(lambda: comm.cart_create([3, 3])),        # too large
            _code(lambda: comm.cart_create([2, 0])),
            _code(lambda: comm.graph_create([1] * 9, [0] * 9)),
            _code(lambda: cart.neighbor_allgather(
                np.zeros(2, np.int64), np.zeros(7, np.int64), count=2)),
            _code(lambda: cart.neighbor_alltoall(
                np.zeros(3, np.int64), np.zeros(8, np.int64), count=1)),
            _code(lambda: cart.neighbor_alltoall(
                np.zeros(4, np.int64), np.zeros(3, np.int64), count=1)),
            _code(lambda: cart.neighbor_alltoall(
                np.zeros(5, np.int64), np.zeros(5, np.int64))),
        ]

    j, p = _both(4, app)
    assert_same(j, p)
    e = port_errors
    assert p[0] == [e.MPI_ERR_TOPOLOGY] * 6 + [
        e.MPI_ERR_ARG, e.MPI_ERR_RANK, e.MPI_ERR_DIMS, e.MPI_ERR_DIMS,
        e.MPI_ERR_TOPOLOGY] + [e.MPI_ERR_ARG] * 4


def test_error_classes_are_the_jax_ones():
    for name in ("MPI_ERR_TOPOLOGY", "MPI_ERR_DIMS", "MPI_ERR_KEYVAL",
                 "MPI_ERR_INFO"):
        assert getattr(port_errors, name) == getattr(jax_errors, name), name


# ---------------------------------------------------------------------------
# what the port alone does
# ---------------------------------------------------------------------------

def test_cpu_tensors_in_place(env):
    """A CPU tensor in a neighbor collective is read and written in place
    as numpy: the same values as the numpy call."""
    def app(comm):
        left, right = _ring(comm)
        dg = comm.dist_graph_create_adjacent([left, right], [left, right])
        s = _vals(20, comm.rank, 4)
        outs = []
        for conv in (torch.from_numpy, lambda a: a):
            rb = conv(np.zeros(4, np.int64))
            dg.neighbor_alltoall(conv(s.copy()), rb, count=2)
            ab = conv(np.zeros(2, np.int64))
            dg.neighbor_allgather(conv(s[:1].copy()), ab, count=1)
            vb = conv(np.zeros(3, np.int64))
            dg.neighbor_alltoallv(conv(s.copy()), [1, 2], [0, 1], vb,
                                  [2, 1], [0, 2])
            outs.append([np.asarray(x) for x in (rb, ab, vb)])
        return outs

    for t, n in run_ranks(4, app, device="cpu", timeout=TIMEOUT):
        assert_same(t, n)


def _card(n, dtype=torch.int64):
    """A tensor that does not lie on the CPU: the meta device stands in
    for the card (as ``tests/test_torch_intercomm.py`` ``_card``)."""
    return torch.empty(n, dtype=dtype, device="meta")


_CARD_CASES = [
    ("neighbor_allgather", lambda c: c.neighbor_allgather(
        _card(2), np.zeros(4, np.int64), count=2)),
    ("neighbor_allgather", lambda c: c.neighbor_allgather(
        np.zeros(2, np.int64), _card(4), count=2)),
    ("neighbor_alltoall", lambda c: c.neighbor_alltoall(
        _card(4), np.zeros(4, np.int64), count=2)),
    ("neighbor_alltoall", lambda c: c.neighbor_alltoall(
        np.zeros(4, np.int64), _card(4), count=2)),
    ("neighbor_alltoallv", lambda c: c.neighbor_alltoallv(
        _card(3), [1, 2], [0, 1], np.zeros(3, np.int64), [2, 1], [0, 2])),
    ("neighbor_alltoallv", lambda c: c.neighbor_alltoallv(
        np.zeros(3, np.int64), [1, 2], [0, 1], _card(3), [2, 1], [0, 2])),
]


@pytest.mark.parametrize("topo", ["cart", "dist_graph", "empty"])
@pytest.mark.parametrize("name,call", _CARD_CASES,
                         ids=[f"{c[0]}_{'send' if i % 2 == 0 else 'recv'}"
                              for i, c in enumerate(_CARD_CASES)])
def test_card_tensor_refused(env, name, call, topo):
    """A tensor on the card in a neighbor collective raises
    NotImplementedError naming the call on every rank, before any data
    moves (a rank with no neighbors too), and is never staged to the
    host (``to_host`` raises while the calls run); the comm still works
    after it."""
    from mvapich2_tpu_torch.core import comm as comm_mod
    from mvapich2_tpu_torch.core import topo as topo_mod

    def app(world):
        if topo == "cart":
            c = world.cart_create([world.size], periods=[True])
        elif topo == "dist_graph":
            left, right = _ring(world)
            c = world.dist_graph_create_adjacent([left, right],
                                                 [left, right])
        else:
            c = world.dist_graph_create_adjacent([], [])
        with pytest.raises(NotImplementedError, match=name) as ei:
            call(c)
        c.barrier()
        return str(ei.value)

    def no_staging(t):
        raise AssertionError("a tensor on the card was staged")
    real = (topo_mod.to_host, comm_mod.to_host)
    topo_mod.to_host = comm_mod.to_host = no_staging
    try:
        got = run_ranks(4, app, device="cpu", timeout=TIMEOUT)
    finally:
        topo_mod.to_host, comm_mod.to_host = real
    assert all("is not moved to the host" in g and "meta" in g for g in got)


def test_topology_comms_bind_channels(env):
    """On a run bound to a device (the CPU here), a cart, its rows, a
    dist graph and a graph bind the slot channel by their geometry, and
    a tensor allreduce over a row runs on it with the summed result; a
    rank that a cart leaves out holds no comm and no channel."""
    def app(world):
        cart = world.cart_create(port_topo.dims_create(world.size, 2),
                                 periods=[True, True])
        row = cart.cart_sub([False, True])
        t = torch.full((64,), float(cart.rank + 1))
        got = row.allreduce(t)
        want = float(sum(cart.topo.rank_of([cart.cart_coords()[0], j]) + 1
                         for j in range(row.size)))
        dg = world.dist_graph_create_adjacent(*[[(world.rank + 1) %
                                                 world.size]] * 2)
        small = world.cart_create([2], periods=[False])
        return (cart.device_channel is not None,
                row.device_channel is not None,
                dg.device_channel is not None,
                isinstance(got, torch.Tensor) and bool((got == want).all()),
                small is None or small.device_channel is not None,
                small is None)

    got = run_ranks(8, app, device="cpu", timeout=TIMEOUT)
    for r, g in enumerate(got):
        assert g[:5] == (True,) * 5, (r, g)
        assert g[5] == (r >= 2)
