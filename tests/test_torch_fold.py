"""Parity of the port's fold channel and multi-axis 1:1 channel
(mvapich2_tpu_torch/coll/device.py DeviceFoldChannel and the multi-axis
DeviceCollChannel, through run_ranks; here on the CPU, so every kernel
wrapper takes its plain version) with the JAX package's run_ranks on the
same geometry over the 8-device virtual CPU mesh, whose collectives take
the stock lowering there:

* fold: 8 ranks over a 4- and a 2-device mesh, 16 ranks over a (2, 4)
  device mesh (k = 2, 4 and 2 ranks a device);
* multi-axis 1:1: 8 ranks on (2, 4), (4, 2) and (1, 8), 4 on (2, 2), as
  tests/test_hier_coll.py drives the JAX package.

Both sides get the same integer-valued per-rank numpy inputs, on which
every fold order gives the same bits: the comparisons are bitwise. The
JAX collectives are forced onto the device (MV2T_<COLL>_ALGO=device), as
are the port's (the numpy buffers here sit below DEVICE_COLL_MIN_BYTES).

Every MV2T_* change is restored, and both configs reloaded, in the
``env`` fixture's teardown; the JAX package is kept from loading its
measured CPU profile."""

import numpy as np
import pytest

import jax
import torch

from mvapich2_tpu import autotune as jax_autotune
from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.coll import tuning as jax_tuning  # noqa: F401 - declares the <COLL>_ALGO cvars
from mvapich2_tpu.core import op as jop
from mvapich2_tpu.ops import pallas_ici
from mvapich2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import make_mesh, mpit, run_ranks
from mvapich2_tpu_torch.coll.device import DeviceCollChannel, \
    DeviceFoldChannel
from mvapich2_tpu_torch.core import op as top
from mvapich2_tpu_torch.ops import alltoall, hbm, ici
from mvapich2_tpu_torch.utils.config import get_config

_ALGOS = ["ALLREDUCE", "REDUCE", "BCAST", "ALLGATHER", "ALLTOALL",
          "REDUCE_SCATTER"]
COUNTS = (1024, 1025, 4096)
AXES = ("x", "y")


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages; the
    collectives of both are forced onto the device. The teardown
    restores the environment and reloads both configs."""
    monkeypatch.setattr(jax_autotune, "_default_attempted", True)
    monkeypatch.setattr(jax_tuning, "_DEVICE_CROSSOVERS", {})
    monkeypatch.setattr(jax_tuning, "_KERNEL_PARAMS", {})

    def set_env(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(f"MV2T_{k}", raising=False)
            else:
                monkeypatch.setenv(f"MV2T_{k}", str(v))
        jax_config().reload()
        get_config().reload()
    set_env(**{f"{c}_ALGO": "device" for c in _ALGOS})
    yield set_env
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()


def _both(nranks, shape, app):
    """``app(comm, ops)`` on ``nranks`` ranks over a mesh of ``shape`` on
    both sides; returns (port, jax) per-rank results."""
    axes = AXES[:len(shape)] if len(shape) > 1 else ("x",)
    ndev = int(np.prod(shape))
    mine = run_ranks(nranks, app, top,
                     device_mesh=make_mesh(shape, axes, "cpu"))
    ref = jax_run_ranks(nranks, lambda comm: app(comm, jop),
                        device_mesh=jax_make_mesh(shape, axes,
                                                  jax.devices()[:ndev]))
    return mine, ref


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(mine, ref):
    for got, want in zip(mine, ref):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))


def _x(rank, cnt, dt):
    """Rank ``rank``'s small-integer input (exact under every order)."""
    return ((np.arange(cnt) * 7 + rank * 13) % 251 - 100).astype(dt)


def _surface(dtype):
    """Every collective the fold channel runs, at each of COUNTS: the
    four allreduce ops, reduce (root 3), bcast from a root on another
    device, allgather and reduce_scatter_block."""
    def app(comm, ops):
        r, n = comm.rank, comm.size
        broot = n - 3
        out = []
        for cnt in COUNTS:
            x = _x(r, cnt, dtype)
            out.append(_np(comm.allreduce(x.copy())))
            out.append(_np(comm.allreduce(x.copy(), op=ops.MAX)))
            out.append(_np(comm.allreduce(x.copy(), op=ops.MIN)))
            out.append(_np(comm.allreduce((np.abs(x) % 2 + 1).astype(dtype),
                                          op=ops.PROD)))
            red = comm.reduce(x.copy(), root=3)
            out.append(_np(red) if r == 3 else np.zeros(1, dtype))
            buf = x.copy() if r == broot else np.zeros(cnt, dtype)
            comm.bcast(buf, root=broot)
            out.append(buf)
            out.append(_np(comm.allgather(x.copy())))
            c = cnt // n
            out.append(_np(comm.reduce_scatter_block(x[:c * n].copy(),
                                                     count=c)))
        return out
    return app


SUM_CALLS = 3 * len(COUNTS)      # allreduce, reduce, reduce_scatter_block
CALLS = 8 * len(COUNTS)


@pytest.mark.parametrize("nranks,shape", [(8, (4,)), (8, (2,)),
                                          (16, (2, 4))],
                         ids=["8r-4dev", "8r-2dev", "16r-2x4dev"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_fold_matches_jax(env, nranks, shape, dtype):
    ndev = int(np.prod(shape))
    chip0 = mpit.pvar("coll_level_chip").read()
    ici0 = mpit.pvar("coll_level_ici").read()
    hbm.reset_counts()

    def kinds(comm, ops):
        ch = comm.device_channel
        if ops is not top:
            return None
        return isinstance(ch, DeviceFoldChannel), ch.k, ch.ndev
    app = _surface(dtype)
    mine, ref = _both(nranks, shape,
                      lambda comm, ops: [kinds(comm, ops)] + app(comm, ops))
    assert {m[0] for m in mine} == {(True, nranks // ndev, ndev)}
    _check([m[1:] for m in mine], [r[1:] for r in ref])
    # every call rides both levels, once per rank
    assert mpit.pvar("coll_level_chip").read() == chip0 + nranks * CALLS
    assert mpit.pvar("coll_level_ici").read() == ici0 + nranks * CALLS
    # the chip fold of a sum: one K1 a device
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == ndev * SUM_CALLS
    for cnt, got in zip(COUNTS, mine[0][1::8]):
        want = sum(_x(r, cnt, np.int64) for r in range(nranks))
        np.testing.assert_array_equal(got, want.astype(dtype))


def test_fold_ranks_of_a_device_share_its_output(env):
    """Tensor buffers on 16 ranks over a (2, 4) device mesh: the ranks of
    one device get the same output tensor, ranks of different devices
    different ones; reduce_scatter_block slices it per rank; alltoall(v)
    take the host tier, as the JAX package's fold channel sends them
    there, with its results and no kernel launched."""
    def app(comm, ops):
        x = torch.full((256,), float(comm.rank + 1))
        return (comm.allreduce(x), comm.allgather(x[:4].clone()),
                comm.reduce_scatter_block(torch.arange(32.0) + comm.rank,
                                          count=2))

    got = run_ranks(16, app, top,
                    device_mesh=make_mesh((2, 4), AXES, "cpu"))
    for r in range(0, 16, 2):
        assert got[r][0] is got[r + 1][0] and got[r][1] is got[r + 1][1]
    assert len({g[0].data_ptr() for g in got}) == 8
    for r, (ar, ag, rsb) in enumerate(got):
        np.testing.assert_array_equal(ar.numpy(), np.full(256, 136.0))
        np.testing.assert_array_equal(
            ag.numpy(), np.repeat(np.arange(1.0, 17.0), 4))
        np.testing.assert_array_equal(
            rsb.numpy(), (np.arange(2.0 * r, 2.0 * r + 2) * 16 + 120))
    dense = list(range(16))
    launched = {k: dict(m.PLAIN_CALLS) for k, m in
                (("hbm", hbm), ("ici", ici), ("a2a", alltoall))}

    def a2a(comm, ops):
        x = np.arange(16, dtype=np.float32) + 100 * comm.rank
        return (comm.alltoall(x), comm.alltoallv(
            x, [1] * 16, dense, np.zeros(16, np.float32), [1] * 16, dense))

    mine, ref = _both(16, (2, 4), a2a)
    assert launched == {k: dict(m.PLAIN_CALLS) for k, m in
                        (("hbm", hbm), ("ici", ici), ("a2a", alltoall))}
    for r, (got, want) in enumerate(zip(mine, ref)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(got[0], np.arange(16) * 100.0 + r)


# ---------------------------------------------------------------------------
# the multi-axis 1:1 channel
# ---------------------------------------------------------------------------

def _sweep(comm, ops):
    """tests/test_hier_coll.py's allreduce sweep: counts across the chunk
    edges, f32 and i32, each checked against the exact sum."""
    out = []
    for dt in (np.float32, np.int32):
        for cnt in COUNTS:
            x = (np.arange(cnt) % 251 + comm.rank + 1).astype(dt)
            got = _np(comm.allreduce(x)).reshape(-1)
            want = sum((np.arange(cnt) % 251 + r + 1).astype(dt)
                       for r in range(comm.size)).astype(dt)
            np.testing.assert_array_equal(got, want)
            out.append(got)
    return out


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 2), (1, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_multi_axis_matches_single_axis_bitwise(env, shape):
    """The port's analog of test_hier_coll.py's: the 2-D mesh allreduce
    equals the 1-D ring on the same ranks bit for bit, rides the ICI
    level, and equals the JAX package's on the same mesh."""
    nr = shape[0] * shape[1]
    ici0 = mpit.pvar("coll_level_ici").read()
    ici.reset_counts()
    mine, ref = _both(nr, shape, _sweep)
    assert mpit.pvar("coll_level_ici").read() == ici0 + nr * 6
    # every call is at or past DEV_TIER_AXES_MIN (4096 B): the
    # decomposition, two K4 phases a call; one live axis: one K3 a call
    if min(shape) > 1:
        assert ici.PLAIN_CALLS["hbm_ring_reduce_scatter"] == 2 * 6
        assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 0
    else:
        assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 6
    flat = run_ranks(nr, _sweep, top,
                     device_mesh=make_mesh((nr,), ("x",), "cpu"))
    _check(mine, flat)
    _check(mine, ref)


def test_multi_axis_full_op_surface_2x2(env):
    """The port's analog of test_hier_coll.py's full op surface on a 2x2
    mesh, against the JAX package's: alltoall and alltoallv take the
    stock lowering, so K10/K11 are never called."""
    big = 16384

    def app(comm, ops):
        ch = comm.device_channel
        if ops is top:
            assert isinstance(ch, DeviceCollChannel) and ch.multi_axis
            assert ch.axes == AXES
        r = comm.rank
        x = np.arange(big, dtype=np.float32) + r
        out = [_np(comm.allreduce(x))]
        b = np.full(big, float(r), np.float32)
        comm.bcast(b, root=2)
        g = np.empty(4 * big, np.float32)
        comm.allgather(np.full(big, float(r + 10), np.float32), g)
        c = big // 4
        sb = np.arange(big, dtype=np.float32) + 100 * r
        rb = np.empty(big, np.float32)
        comm.alltoall(sb, rb)
        rsb = np.empty(c, np.float32)
        comm.reduce_scatter_block(sb, rsb)
        counts = [[(i + 2 * j) % 3 + 1 for j in range(4)] for i in range(4)]
        send = np.arange(sum(counts[r]), dtype=np.float32) + 1000 * r
        rc = [counts[i][r] for i in range(4)]
        recv = np.zeros(sum(rc), np.float32)
        comm.alltoallv(send, counts[r], list(np.cumsum([0] + counts[r][:-1])),
                       recv, rc, list(np.cumsum([0] + rc[:-1])))
        return out + [b, g, rb, rsb, recv]

    alltoall.reset_counts()
    mine, ref = _both(4, (2, 2), app)
    assert not any(alltoall.PLAIN_CALLS.values())
    _check(mine, ref)
    want = sum(np.arange(big, dtype=np.float32) + r for r in range(4))
    for r, (ar, b, g, rb, rsb, recv) in enumerate(mine):
        np.testing.assert_array_equal(ar, want)
        assert b[0] == 2.0 and g[r * big] == r + 10
        assert rb[0] == r * big // 4


def _planned(name, nbytes, dtype, op, ext):
    return pallas_ici.planned_tier(name, nbytes, dtype, op,
                                   interpret=True, num_devices=ext)


@pytest.mark.parametrize("nranks,shape", [(8, (4,)), (16, (2, 4)),
                                          (8, (2, 4))],
                         ids=["fold-8r-4dev", "fold-16r-2x4", "1to1-2x4"])
def test_tier_pvars_match_the_reference_plan(env, nranks, shape):
    """The port's dev_coll_tier_* move as the JAX package's
    ``planned_tier`` (interpreter on, over the mesh extent) names the
    call's tier: allreduce on the shard bytes, allgather on the bytes of
    all the ranks, on a multi-axis mesh for the whole payload."""
    env(DEV_TIER_VMEM_MAX="8192")
    ndev = int(np.prod(shape))
    calls = [("allreduce", 1024, "sum"), ("allreduce", 4096, "sum"),
             ("allreduce", 1024, "max"), ("allgather", 1024, None),
             ("allgather", 64, None)]
    tiers = ("dev_coll_tier_vmem", "dev_coll_tier_hbm",
             "dev_coll_tier_quant", "dev_coll_fallback_size")
    want = dict.fromkeys(tiers, 0)
    for name, cnt, op in calls:
        nbytes = cnt * 4 * (nranks if name == "allgather" else 1)
        tier, reason = _planned(name, nbytes, np.float32, op, ndev)
        assert reason is None
        want[f"dev_coll_tier_{tier}"] += nranks

    def app(comm, ops):
        x = np.ones(4096, np.float32)
        for name, cnt, op in calls:
            if name == "allreduce":
                comm.allreduce(x[:cnt].copy(),
                               op=ops.MAX if op == "max" else ops.SUM)
            else:
                comm.allgather(x[:cnt].copy())

    before = {k: mpit.pvar(k).read() for k in tiers}
    axes = AXES if len(shape) > 1 else ("x",)
    run_ranks(nranks, app, top, device_mesh=make_mesh(shape, axes, "cpu"))
    got = {k: mpit.pvar(k).read() - before[k] for k in tiers}
    assert got == want
    assert want["dev_coll_tier_vmem"] and want["dev_coll_tier_hbm"]


def test_fold_sums_read_the_deposits_in_place(env, monkeypatch):
    """The chip fold of a sum hands a device's deposits to K1 by address
    and never stages them: with ``_stack_slots`` patched to raise, the
    sum allreduce, reduce and reduce_scatter_block over 8 ranks on a
    4-device mesh still agree with the plain sum (4 K1 a call, one per
    device), while allgather and the stock max, which stack, fail."""
    from mvapich2_tpu_torch.coll import device as cdev

    calls = []

    def staged(*a, **kw):
        calls.append(a)
        raise AssertionError("staged a stacked slot tensor")

    monkeypatch.setattr(cdev, "_stack_slots", staged)
    nranks, c = 8, 40
    data = np.stack([_x(r, nranks * c, np.int32) for r in range(nranks)])

    def app(comm):
        x = torch.from_numpy(data[comm.rank].copy())
        return (comm.allreduce(x), comm.reduce(x, root=5),
                comm.reduce_scatter_block(x))

    mesh = make_mesh((4,), ("x",), "cpu")
    hbm.reset_counts()
    res = run_ranks(nranks, app, device_mesh=mesh)
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == 3 * 4 and not calls
    want = data.sum(0)
    for r, (ar, red, rsb) in enumerate(res):
        np.testing.assert_array_equal(ar.numpy(), want)
        if r == 5:
            np.testing.assert_array_equal(red.numpy(), want)
        np.testing.assert_array_equal(rsb.numpy(), want[r * c:(r + 1) * c])
    for app in (lambda comm: comm.allgather(torch.ones(4)),
                lambda comm: comm.allreduce(torch.ones(4), op=top.MAX)):
        with pytest.raises(RuntimeError):
            run_ranks(nranks, app, device_mesh=mesh, timeout=30)
        assert calls
        calls.clear()
