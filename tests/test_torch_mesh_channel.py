"""Parity of the port's slice as a whole: mvapich2_tpu_torch.run_ranks(8)
bound one to one to a mesh of 8 virtual ranks (here on the CPU, so the
ring wrappers take their plain versions) against the JAX package's
run_ranks(8) bound to make_mesh((8,), ("x",)) over the 8-device virtual
CPU mesh, whose collectives take the stock lowering there. Both sides
get the same seeded per-rank numpy inputs; the JAX side has the
collectives forced onto the device (MV2T_<COLL>_ALGO=device).

Tolerances: rtol 2e-5 / atol 1e-4 on normal f32 data (the stock psum
and the ring fold in different orders); bitwise on integer data and on
the data-movement collectives.

Every MV2T_* change is restored, and both configs reloaded, in the
``env`` fixture's teardown; the JAX package is kept from loading its
measured CPU profile (autotune's load-once flag is patched through
monkeypatch), so no tuning state outlives a test."""

import numpy as np
import pytest

import jax
import torch

from mvapich2_tpu import autotune as jax_autotune
from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.coll import tuning as jax_tuning  # noqa: F401 - declares the <COLL>_ALGO cvars
from mvapich2_tpu.core import op as jop
from mvapich2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import make_mesh, mpit, run_ranks
from mvapich2_tpu_torch.coll.device import DeviceCollChannel, HBMSlotChannel
from mvapich2_tpu_torch.core import op as top
from mvapich2_tpu_torch.ops import hbm, ici, ring
from mvapich2_tpu_torch.utils.config import get_config

NP = 8
RTOL, ATOL = 2e-5, 1e-4
_ALGOS = ["ALLREDUCE", "REDUCE", "BCAST", "ALLGATHER", "ALLTOALL",
          "REDUCE_SCATTER"]


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages; the
    JAX collectives are forced onto the device. The teardown restores
    the environment and reloads both configs."""
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


def _both(app):
    """Run ``app(comm, ops)`` on both sides; return (port, jax) results."""
    mine = run_ranks(NP, app, top,
                     device_mesh=make_mesh((NP,), ("x",), "cpu"))
    ref = jax_run_ranks(NP, lambda comm: app(comm, jop),
                        device_mesh=jax_make_mesh((NP,), ("x",),
                                                  jax.devices()[:NP]))
    return mine, ref


def _inputs(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(NP, n)).astype(np.float32)
    if kind == "intf32":
        return rng.integers(-100, 100, size=(NP, n)).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=(NP, n), dtype=np.int32)
    raise ValueError(kind)


def _check(mine, ref, exact):
    for got, want in zip(mine, ref):
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _counts():
    return (dict(ring.PLAIN_CALLS), dict(ici.PLAIN_CALLS))


# n = 64: the resident ring K6 (sum, n % p == 0); 300: n % p != 0, the
# streaming ring K3
@pytest.mark.parametrize("n,kind,kernel", [
    (64, "normal", "K6"), (64, "intf32", "K6"), (300, "intf32", "K3"),
    (300, "normal", "K3"), (40, "int32", "K6")])
def test_allreduce_sum_parity(env, n, kind, kernel):
    data = _inputs(70 + n, n, kind)

    def app(comm, ops):
        return comm.allreduce(data[comm.rank].copy())

    ring.reset_counts()
    ici.reset_counts()
    mine, ref = _both(app)
    if kernel == "K6":
        assert ring.PLAIN_CALLS["ring_all_reduce"] == 1
    else:
        assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 1
    _check(mine, ref, kind != "normal")


@pytest.mark.parametrize("opname,kind", [("MAX", "int32"), ("MIN", "intf32"),
                                         ("PROD", "intf32")])
def test_allreduce_ops_parity(env, opname, kind):
    data = _inputs(80, 24, kind)
    if opname == "PROD":
        data = np.abs(data) % 3 + 1

    def app(comm, ops):
        return comm.allreduce(data[comm.rank].copy(), op=getattr(ops, opname))

    ici.reset_counts()
    mine, ref = _both(app)
    assert ici.PLAIN_CALLS["hbm_ring_all_reduce"] == 1     # non-sum: K3
    _check(mine, ref, True)


def test_streaming_tier_parity(env):
    """Past DEV_TIER_VMEM_MAX: allreduce and allgather stream (K3, K5)."""
    env(DEV_TIER_VMEM_MAX="256")
    data = _inputs(90, 200, "intf32")             # 800-byte shards

    def app(comm, ops):
        r = comm.rank
        return (comm.allreduce(data[r].copy()),
                comm.allgather(data[r][:40].copy()))

    ring.reset_counts()
    ici.reset_counts()
    hbm0 = mpit.pvar("dev_coll_tier_hbm").read()
    mine, ref = _both(app)
    assert ici.PLAIN_CALLS == {"hbm_ring_all_reduce": 1,
                               "hbm_ring_all_gather": 1}
    assert ring.PLAIN_CALLS == {"ring_all_reduce": 0, "ring_all_gather": 0}
    assert mpit.pvar("dev_coll_tier_hbm").read() == hbm0 + 2 * NP
    for got, want in zip(mine, ref):
        _check(got, want, True)


def test_reduce_bcast_allgather_rsb_parity(env):
    data = _inputs(91, NP * 5, "intf32")
    bdata = _inputs(92, 130, "normal")[0]

    def app(comm, ops):
        r = comm.rank
        red = comm.reduce(data[r].copy(), root=3)
        buf = bdata.copy() if r == 2 else np.zeros(130, np.float32)
        comm.bcast(buf, root=2)
        ag = comm.allgather(np.full(7, r, np.int32))
        rsb = comm.reduce_scatter_block(data[r].copy(), count=5)
        rsm = comm.reduce_scatter_block(data[r].copy(), count=5, op=ops.MAX)
        return (red if r == 3 else np.zeros(1)), buf, ag, rsb, rsm

    ring.reset_counts()
    vmem0 = mpit.pvar("dev_coll_tier_vmem").read()
    mine, ref = _both(app)
    assert ring.PLAIN_CALLS == {"ring_all_reduce": 1, "ring_all_gather": 1}
    # the reduce and the allgather plan the small tier; bcast and the
    # reduce_scatter_blocks take the stock lowering and count no tier
    assert mpit.pvar("dev_coll_tier_vmem").read() == vmem0 + 2 * NP
    for got, want in zip(mine, ref):
        _check(got, want, True)
    np.testing.assert_array_equal(mine[3][0], data.sum(0))
    np.testing.assert_array_equal(mine[0][1], bdata)


def test_stock_lowering_counts_once_per_rank(env):
    """A call the tier dispatch sends to the stock reduction counts
    dev_coll_fallback_size once on each rank, as the JAX channel's
    _note_tier does; the dispatcher under the channel adds nothing."""
    env(DEV_TIER_VMEM_MAX="64", DEV_TIER_XLA_MIN="256")
    data = _inputs(93, 100, "intf32")             # 400-byte shards

    def app(comm, ops):
        r = comm.rank
        return (comm.allreduce(data[r].copy()),
                comm.allgather(data[r][:40].copy()))  # 1280-byte output

    before = mpit.pvar("dev_coll_fallback_size").read()
    ring.reset_counts()
    ici.reset_counts()
    mine = run_ranks(NP, app, top, device_mesh=make_mesh((NP,), ("x",),
                                                         "cpu"))
    assert mpit.pvar("dev_coll_fallback_size").read() == before + 2 * NP
    assert _counts() == ({"ring_all_reduce": 0, "ring_all_gather": 0},
                         {"hbm_ring_all_reduce": 0,
                          "hbm_ring_all_gather": 0})
    for ar, ag in mine:
        np.testing.assert_array_equal(ar, data.sum(0))
        np.testing.assert_array_equal(ag, data[:, :40].reshape(-1))


class _ErrorWord:
    """Stands in for the loaded ring library: its error word reads
    ``code`` until a read clears it, as a timed-out spin leaves it."""

    def __init__(self, code):
        self.code = code

    def mv2t_ring_error(self, clear):
        code = self.code
        if clear:
            self.code = 0
        return code


def test_ring_spin_timeout_raises_on_every_rank(env, monkeypatch):
    """The error word a timed-out ring kernel leaves is read after the
    call that set it: every rank of that call raises, and the next call
    runs."""
    from mvapich2_tpu_torch.ops import _build
    monkeypatch.setitem(_build._loaded, "ring", _ErrorWord(2))

    def app(comm, ops):
        try:
            comm.allreduce(np.ones(64, np.float32))
            first = None
        except RuntimeError as e:
            first = str(e.__cause__)
        return first, comm.allreduce(np.ones(64, np.float32))

    got = run_ranks(NP, app, top, device_mesh=make_mesh((NP,), ("x",),
                                                        "cpu"))
    for msg, second in got:
        assert msg is not None and "spin bound" in msg
        np.testing.assert_array_equal(second, np.full(64, float(NP)))


def test_tensor_results_are_one_per_rank(env):
    """Tensor buffers: each rank gets its own output tensor (the 1:1
    channel's per-device shards), not one shared tensor."""
    def app(comm, ops):
        return comm.allreduce(torch.full((256,), float(comm.rank + 1)))

    got = run_ranks(NP, app, top, device_mesh=make_mesh((NP,), ("x",),
                                                        "cpu"))
    assert len({t.data_ptr() for t in got}) == NP
    for t in got:
        np.testing.assert_array_equal(t.numpy(), np.full(256, 36.0))


def test_channel_levels_and_tier_pvars(env):
    ici0 = mpit.pvar("coll_level_ici").read()
    chip0 = mpit.pvar("coll_level_chip").read()
    vmem0 = mpit.pvar("dev_coll_tier_vmem").read()

    def app(comm, ops):
        assert type(comm.device_channel) is DeviceCollChannel
        comm.allreduce(np.ones(128, np.float32))
        comm.allreduce(np.ones(128, np.int8), op=ops.MAX)

    mesh = make_mesh((NP,), ("x",), "cpu")
    run_ranks(NP, app, top, device_mesh=mesh)
    # each rank's call counts once, as in the JAX package's _run
    assert mpit.pvar("coll_level_ici").read() == ici0 + 2 * NP
    assert mpit.pvar("dev_coll_tier_vmem").read() == vmem0 + 2 * NP
    assert mpit.pvar("coll_level_chip").read() == chip0
    assert mpit.pvar("dev_effbw_vmem").read() > 0
    # what the JAX package sends to its host tier raises here
    with pytest.raises(RuntimeError) as ei:
        run_ranks(NP, lambda c, ops: c.allreduce(np.ones(4, np.float64)),
                  top, device_mesh=mesh, timeout=30)
    assert isinstance(ei.value.__cause__, NotImplementedError)


def test_one_rank_mesh_binds_the_mesh_channel(env):
    """The R=1 case binds the 1:1 channel, as the JAX package does; no
    mesh keeps the slot channel (PR-1 behaviour)."""
    def app(comm, ops):
        return type(comm.device_channel), comm.allreduce(
            np.arange(5, dtype=np.float32))

    (kind, out), = run_ranks(1, app, top,
                             device_mesh=make_mesh((1,), ("x",), "cpu"))
    assert kind is DeviceCollChannel
    np.testing.assert_array_equal(out, np.arange(5, dtype=np.float32))
    (kind, _), = run_ranks(1, app, top, device="cpu")
    assert kind is HBMSlotChannel
    # one mesh rank under several ranks: the slot channel on its device
    hbm.reset_counts()
    kinds = run_ranks(3, app, top, device_mesh=make_mesh((1,), ("x",),
                                                         "cpu"))
    assert {k for k, _ in kinds} == {HBMSlotChannel}
    assert hbm.PLAIN_CALLS["fused_reduce_to_slot"] == 1


def test_unported_geometry_and_alltoall_raise(env):
    with pytest.raises(NotImplementedError, match="fold channel"):
        run_ranks(8, lambda c: None, device_mesh=make_mesh((4,), ("x",),
                                                           "cpu"))
    with pytest.raises(NotImplementedError, match="1-D"):
        make_mesh((2, 4), ("x", "y"), "cpu")
    with pytest.raises(RuntimeError) as ei:
        run_ranks(NP, lambda c: c.alltoall(np.arange(NP, dtype=np.float32)),
                  device_mesh=make_mesh((NP,), ("x",), "cpu"), timeout=30)
    assert isinstance(ei.value.__cause__, NotImplementedError)


def test_cuda_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((NP,), ("x",), "cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(NP, lambda c: None, device="cuda:0")
