"""Parity of the port's slice as a whole: mvapich2_tpu_torch.run_ranks
(ranks sharing one device through the slot channel, here device="cpu")
against the JAX package's run_ranks bound to a one-device mesh with the
collectives forced onto the device, as tests/test_pallas_hbm.py runs it.
Both sides get the same per-rank numpy inputs.

Tolerances: rtol 2e-5 / atol 1e-4 on normal f32 data; bitwise on
integer-valued data and on the data-movement collectives."""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.coll import tuning as _jax_tuning  # noqa: F401 - declares the <COLL>_ALGO cvars
from mvapich2_tpu.core import op as jop
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import run_ranks
from mvapich2_tpu_torch.coll.device import HBMSlotChannel
from mvapich2_tpu_torch.core import op as top
from mvapich2_tpu_torch.ops import hbm
from mvapich2_tpu_torch import mpit

RTOL, ATOL = 2e-5, 1e-4
_ALGOS = ["ALLREDUCE", "REDUCE", "BCAST", "ALLGATHER", "ALLTOALL",
          "REDUCE_SCATTER"]


@pytest.fixture(autouse=True)
def _port_forced_onto_the_device():
    """The port's collectives forced onto the device too: the small
    numpy buffers here are below DEVICE_COLL_MIN_BYTES, where the JAX
    package would take its host tier unless forced."""
    from mvapich2_tpu_torch.utils.config import get_config
    cfg = get_config()
    for n in _ALGOS:
        cfg.set(f"{n}_ALGO", "device")
    yield
    cfg.reload()


def _jax_run(nranks, fn):
    from mvapich2_tpu.parallel.mesh import make_mesh
    cfg = jax_config()
    for n in _ALGOS:
        cfg.set(f"{n}_ALGO", "device")
    try:
        return jax_run_ranks(nranks, fn, device_mesh=make_mesh(
            (1,), ("x",), jax.devices()[:1]))
    finally:
        for n in _ALGOS:
            cfg.set(f"{n}_ALGO", "")


def _both(nranks, app):
    """Run ``app(comm, ops)`` on both sides; return (port, jax) results."""
    return (run_ranks(nranks, app, top, device="cpu"),
            _jax_run(nranks, lambda comm: app(comm, jop)))


def _inputs(seed, nranks, n, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-100, 100, size=(nranks, n)).astype(np.float32)
    return rng.normal(size=(nranks, n)).astype(np.float32)


@pytest.mark.parametrize("nranks", [4, 5])
@pytest.mark.parametrize("integer", [False, True])
def test_allreduce_sum_parity(nranks, integer):
    n = 300                       # ragged: not a multiple of 128
    data = _inputs(20 + nranks, nranks, n, integer)

    def app(comm, ops):
        return comm.allreduce(data[comm.rank].copy())

    hbm.reset_counts()
    mine, ref = _both(nranks, app)
    # the plain K1 route ran once for the one sum-allreduce
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == 1
    for got, want in zip(mine, ref):
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("opname", ["MAX", "MIN", "PROD"])
def test_allreduce_stock_ops_parity(opname):
    nranks, n = 4, 64
    data = _inputs(30, nranks, n) * 0.5 + 1.0

    def app(comm, ops):
        return comm.allreduce(data[comm.rank].copy(), op=getattr(ops, opname))

    hbm.reset_counts()
    mine, ref = _both(nranks, app)
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == 0   # stock path
    for got, want in zip(mine, ref):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_reduce_parity():
    nranks, n = 4, 256
    data = _inputs(31, nranks, n, integer=True)

    def app(comm, ops):
        return comm.reduce(data[comm.rank].copy(), root=1)

    hbm.reset_counts()
    mine, ref = _both(nranks, app)
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == 1
    np.testing.assert_array_equal(mine[1], ref[1])
    np.testing.assert_array_equal(mine[1], data.sum(0))


def test_bcast_allgather_alltoall_rsb_parity():
    nranks = 4
    bdata = _inputs(32, 1, 130)[0]
    data = _inputs(33, nranks, nranks * 5, integer=True)

    def app(comm, ops):
        p = comm.size
        buf = bdata.copy() if comm.rank == 2 else np.zeros(130, np.float32)
        comm.bcast(buf, root=2)
        ag = comm.allgather(np.full(7, comm.rank, np.float32))
        a2a = comm.alltoall(np.arange(p * 3, dtype=np.float32)
                            + 100 * comm.rank)
        rsb = comm.reduce_scatter_block(data[comm.rank].copy(), count=5)
        return buf, ag, a2a, rsb

    hbm.reset_counts()
    mine, ref = _both(nranks, app)
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == 1   # the rsb
    for got, want in zip(mine, ref):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(mine[0][0], bdata)


@pytest.mark.parametrize("np_dtype", [np.uint16, np.uint32])
def test_unsigned_sum_parity(np_dtype):
    """uint16 and uint32 sums through the slot kernel (K1) wrap as the
    JAX kernel's do."""
    info = np.iinfo(np_dtype)
    rng = np.random.default_rng(info.bits)
    data = rng.integers(info.max // 2, info.max, size=(4, 200),
                        endpoint=True).astype(np_dtype)

    def app(comm, ops):
        return comm.allreduce(data[comm.rank].copy())

    hbm.reset_counts()
    mine, ref = _both(4, app)
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == 1
    for got, want in zip(mine, ref):
        assert got.dtype == np_dtype
        np.testing.assert_array_equal(got, np.asarray(want))


def test_zero_copy_shared_result():
    """Tensor buffers: every rank's allreduce result is the SAME tensor
    (the shared slot), as the JAX package hands every rank one array."""
    got = {}
    ref = {}

    def app(comm):
        sb = torch.full((256,), float(comm.rank + 1))
        got[comm.rank] = comm.allreduce(sb)

    def jax_app(comm):
        sb = jnp.asarray(np.full(256, float(comm.rank + 1), np.float32))
        ref[comm.rank] = comm.allreduce(sb, recvbuf=None)

    run_ranks(3, app, device="cpu")
    _jax_run(3, jax_app)
    assert got[0] is got[1] is got[2]
    assert ref[0] is ref[1] is ref[2]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def test_channel_and_pvars():
    chip0 = mpit.pvar("coll_level_chip").read()

    def app(comm):
        assert type(comm.device_channel) is HBMSlotChannel
        comm.allreduce(np.ones(128, np.float32))
        comm.allreduce(np.ones(128, np.float32))

    run_ranks(4, app, device="cpu")
    # each rank's call counts once, as in the JAX package's _run
    assert mpit.pvar("coll_level_chip").read() == chip0 + 8
    assert mpit.pvar("dev_effbw_slot").read() > 0


def test_failing_rank_releases_peers():
    """A rank that raises before a collective: its peers fail with an
    error instead of hanging, and run_ranks reports it well inside the
    timeout."""
    def app(comm):
        if comm.rank == 1:
            raise ValueError("boom")
        comm.allreduce(np.ones(16, np.float32))

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 failed") as ei:
        run_ranks(3, app, device="cpu", timeout=30)
    assert "peer rank failed" in str(ei.value.__cause__)
    assert time.monotonic() - t0 < 20


def test_hung_rank_times_out():
    import threading
    release = threading.Event()

    def app(comm):
        if comm.rank == 0:
            release.wait(5)       # hangs past the harness timeout
        else:
            comm.allreduce(np.ones(4, np.float32))

    with pytest.raises(TimeoutError):
        run_ranks(2, app, device="cpu", timeout=0.5)
    release.set()


def test_host_tier_cases_raise(monkeypatch):
    """What the JAX package sends to its host tier (an 8-byte dtype, a
    user-defined op, a forced host algorithm) no longer raises: it runs
    on the port's host tier from the slot channel, with no slot launch,
    bitwise as the JAX package runs it from its slot channel."""
    from mvapich2_tpu_torch.utils.config import get_config

    def app(lib_op, case):
        def run(comm):
            x = np.arange(6, dtype=np.float32) * (comm.rank + 1)
            if case == "f64":
                return comm.allreduce(x.astype(np.float64))
            if case == "user":
                return comm.allreduce(x, op=lib_op.Op(np.add, "user"))
            return comm.allreduce(x)
        return run

    for case in ("f64", "user", "ring"):
        if case == "ring":
            monkeypatch.setenv("MV2T_ALLREDUCE_ALGO", "ring")
            jax_config().reload()
            get_config().set("ALLREDUCE_ALGO", "ring")
        before = dict(hbm.PLAIN_CALLS)
        got = run_ranks(2, app(top, case), device="cpu", timeout=30)
        assert hbm.PLAIN_CALLS == before
        if case == "ring":
            from mvapich2_tpu.parallel.mesh import make_mesh
            want = jax_run_ranks(2, app(jop, case), timeout=30,
                                 device_mesh=make_mesh(
                                     (1,), ("x",), jax.devices()[:1]))
        else:
            want = _jax_run(2, app(jop, case))
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            assert g.tobytes() == np.asarray(w).tobytes()
    monkeypatch.delenv("MV2T_ALLREDUCE_ALGO")
    jax_config().reload()


def test_sum_reductions_read_the_deposits_in_place(monkeypatch):
    """Tensor deposits: the sum allreduce, reduce and reduce_scatter_block
    hand the ranks' own tensors to K1 by address (``hbm_slot_allreduce``
    on the list) and never stage them. With ``_stack_slots`` patched to
    raise, they still agree with the plain sum, while allgather and the
    stock max, which do stage, fail on the leader."""
    from mvapich2_tpu_torch.coll import device as cdev

    calls = []

    def staged(*a, **kw):
        calls.append(a)
        raise AssertionError("staged a stacked slot tensor")

    monkeypatch.setattr(cdev, "_stack_slots", staged)
    nranks, c = 4, 75
    data = _inputs(41, nranks, nranks * c, integer=True)

    def app(comm):
        x = torch.from_numpy(data[comm.rank].copy())
        return (comm.allreduce(x), comm.reduce(x, root=2),
                comm.reduce_scatter_block(x))

    hbm.reset_counts()
    res = run_ranks(nranks, app, device="cpu")
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == 3 and not calls
    want = data.sum(0)
    for r, (ar, red, rsb) in enumerate(res):
        np.testing.assert_array_equal(ar.numpy(), want)
        if r == 2:
            np.testing.assert_array_equal(red.numpy(), want)
        np.testing.assert_array_equal(rsb.numpy(), want[r * c:(r + 1) * c])
    for app in (lambda comm: comm.allgather(torch.ones(4)),
                lambda comm: comm.allreduce(torch.ones(4), op=top.MAX)):
        with pytest.raises(RuntimeError):
            run_ranks(nranks, app, device="cpu", timeout=30)
        assert calls
        calls.clear()
