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
from mvapich2_tpu_torch.parallel import MeshComm
from mvapich2_tpu_torch.rma import DeviceWin
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
                               "hbm_ring_all_gather": 1,
                               "quant_ring_all_reduce": 0,
                               "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0}
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
                          "hbm_ring_all_gather": 0,
                          "quant_ring_all_reduce": 0,
                          "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0})
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
    # what the JAX package sends to its host tier runs there, moving no
    # device pvar
    got = run_ranks(NP, lambda c, ops: c.allreduce(
        np.arange(4, dtype=np.float64) + c.rank), top, device_mesh=mesh,
        timeout=30)
    for out in got:
        assert out.dtype == np.float64
        np.testing.assert_array_equal(out, np.arange(4) * NP + 28)
    assert mpit.pvar("coll_level_ici").read() == ici0 + 2 * NP


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
    """What the JAX package keeps on its host path runs on the port's host
    tier, with the JAX package's results: a mesh that neither covers the
    ranks one to one nor divides them binds no channel (6 ranks over 4
    devices), alltoall(v) on the fold channel and alltoallv on the slot
    channel. A DeviceWin on a multi-axis mesh still raises (host windows
    are not ported). Alltoall itself runs on the 1:1 channel (K10)."""
    for c in _ALGOS:
        env(**{f"{c}_ALGO": None})
    jdev = jax.devices()
    dense = [0, 1, 2, 3, 4, 5, 6, 7]
    ones = [1] * NP

    def odd(comm, ops):
        return (comm.device_channel is None,
                comm.allreduce(np.arange(6, dtype=np.int32) * comm.rank))

    mine = run_ranks(6, odd, top, device_mesh=make_mesh((4,), ("x",),
                                                        "cpu"), timeout=30)
    ref = jax_run_ranks(6, lambda c: odd(c, jop), timeout=30,
                        device_mesh=jax_make_mesh((4,), ("x",), jdev[:4]))
    for (unbound, got), (_, want) in zip(mine, ref):
        assert unbound
        np.testing.assert_array_equal(got, want)

    def a2a(comm, ops):
        x = np.arange(NP, dtype=np.float32) + 10 * comm.rank
        return (comm.alltoall(x), comm.alltoallv(
            x, ones, dense, np.zeros(NP, np.float32), ones, dense))

    for pmesh, jmesh in ((make_mesh((4,), ("x",), "cpu"),
                          jax_make_mesh((4,), ("x",), jdev[:4])),
                         (None, jax_make_mesh((1,), ("x",), jdev[:1]))):
        mine = run_ranks(NP, a2a, top, device_mesh=pmesh, timeout=30,
                         device=None if pmesh else "cpu")
        ref = jax_run_ranks(NP, lambda c: a2a(c, jop), timeout=30,
                            device_mesh=jmesh)
        for r, (got, want) in enumerate(zip(mine, ref)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(got[0], np.arange(NP) * 10.0 + r)
    with pytest.raises(NotImplementedError, match="multi-axis mesh"):
        DeviceWin(MeshComm(make_mesh((2, 4), ("x", "y"), "cpu")), 16)
    got = run_ranks(NP, lambda c: c.alltoall(np.arange(NP, dtype=np.float32)
                                             + 10 * c.rank),
                    device_mesh=make_mesh((NP,), ("x",), "cpu"))
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out, np.arange(NP) * 10.0 + r)


def test_cuda_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((NP,), ("x",), "cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(NP, lambda c: None, device="cuda:0")


# ---------------------------------------------------------------------------
# the quant tier end to end, and the faults this slice repaired
# ---------------------------------------------------------------------------

def test_quant_tier_end_to_end(env, monkeypatch):
    """A 1 MiB f32 allreduce under MV2T_QUANT_COLL=5e-2 (past a lowered
    vmem edge, at the default 1 MiB quant edge) takes the quant tier on
    both sides: bitwise the JAX channel's result (its K9 in interpret
    mode), every rank the same, within declared_bound(8) of an f64 sum;
    dev_coll_tier_quant and dev_coll_quant_bytes_saved counted on every
    rank, as in the JAX package."""
    from mvapich2_tpu import mpit as jax_mpit
    from mvapich2_tpu.ops import pallas_ici
    from mvapich2_tpu_torch.ops import quant
    # the interpreter cannot signal a remote semaphore: creditless
    monkeypatch.setattr(pallas_ici, "have_remote_signal", lambda: False)
    env(QUANT_COLL="5e-2", DEV_TIER_VMEM_MAX="16", ICI_INTERPRET="1")
    n = 1 << 18
    data = _inputs(94, n, "normal")

    def app(comm, ops):
        return comm.allreduce(data[comm.rank].copy())

    pv = ("dev_coll_tier_quant", "dev_coll_quant_bytes_saved")
    mine0 = {k: mpit.pvar(k).read() for k in pv}
    ref0 = {k: jax_mpit.pvar(k).read() for k in pv}
    ici.reset_counts()
    mine, ref = _both(app)
    assert ici.PLAIN_CALLS == {"hbm_ring_all_reduce": 0,
                               "hbm_ring_all_gather": 0,
                               "quant_ring_all_reduce": 1,
                               "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0}
    for got, want in zip(mine, ref):
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(want).view(np.int32))
        np.testing.assert_array_equal(got, mine[0])
    exp = data.astype(np.float64).sum(0)
    rel = np.abs(mine[0] - exp).max() / np.abs(exp).max()
    assert rel <= quant.declared_bound(NP, "q8")
    exact_b, wire_b = quant.wire_stats(n, torch.float32, NP)
    assert (exact_b, wire_b) == (14 * n // NP * 4, 14 * 33 * n // NP // 32)
    for k, per_rank in (("dev_coll_tier_quant", 1),
                        ("dev_coll_quant_bytes_saved", exact_b - wire_b)):
        assert mpit.pvar(k).read() - mine0[k] == NP * per_rank
        assert jax_mpit.pvar(k).read() - ref0[k] == NP * per_rank


def test_quant_bin_ineligible_calls_run_exact(env):
    """Under MV2T_QUANT_COLL=5e-2 the quant bin holds an int32 sum, an
    f32 max (1 MiB a rank) and a 1 MiB allgather, which it cannot
    quantize: they take the exact streaming ring (K3, K5) and match the
    JAX channel bitwise, where the port used to raise."""
    env(QUANT_COLL="5e-2", DEV_TIER_VMEM_MAX="16")
    ints = _inputs(95, 1 << 18, "int32")
    flts = _inputs(96, 1 << 18, "normal")

    def app(comm, ops):
        r = comm.rank
        return (comm.allreduce(ints[r].copy()),
                comm.allreduce(flts[r].copy(), op=ops.MAX),
                comm.allgather(flts[r][:(1 << 15)].copy()))

    ici.reset_counts()
    q0 = mpit.pvar("dev_coll_tier_quant").read()
    h0 = mpit.pvar("dev_coll_tier_hbm").read()
    mine, ref = _both(app)
    assert ici.PLAIN_CALLS == {"hbm_ring_all_reduce": 2,
                               "hbm_ring_all_gather": 1,
                               "quant_ring_all_reduce": 0,
                               "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0}
    assert mpit.pvar("dev_coll_tier_quant").read() == q0
    assert mpit.pvar("dev_coll_tier_hbm").read() == h0 + 3 * NP
    for got, want in zip(mine, ref):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_forced_device_wins_over_use_device_coll_off(env):
    """MV2T_<COLL>_ALGO=device runs on the device with USE_DEVICE_COLL
    off, as the JAX package's _select_transport decides; without the
    force the call takes the host tier, bitwise the JAX package's."""
    env(USE_DEVICE_COLL="0")
    data = _inputs(97, 64, "intf32")

    def app(comm, ops):
        return comm.allreduce(data[comm.rank].copy())

    mine, ref = _both(app)
    _check(mine, ref, True)
    env(ALLREDUCE_ALGO=None)
    before = _counts()
    mine, ref = _both(app)
    _check(mine, ref, True)
    assert _counts() == before


def test_transport_selection_matches_jax(env):
    """The port's _select_transport against the JAX one over a grid of
    collectives, byte counts, buffer residency, dtypes, ops and cvars:
    'device' where the JAX package picks the device, and 'host' where it
    picks the host: below DEVICE_COLL_MIN_BYTES for a numpy buffer, a
    forced host algorithm, USE_DEVICE_COLL off, an op or dtype that does
    not lower (forced or not)."""
    import jax.numpy as jnp
    from mvapich2_tpu.coll import device as jax_device
    from mvapich2_tpu_torch.coll import device as port_device
    ops = {"sum": (top.SUM, jop.SUM),
           "user": (top.Op(np.add, "user"), jop.Op(np.add, "user"))}
    bufs = {"np32": (np.zeros(4, np.float32),) * 2,
            "np64": (np.zeros(4, np.float64),) * 2,
            "dev32": (torch.zeros(4), jnp.zeros(4, jnp.float32))}
    cases = 0
    for min_bytes in (None, "1024", "0"):
        for use in (None, "0"):
            for forced in (None, "device", "ring"):
                env(DEVICE_COLL_MIN_BYTES=min_bytes, USE_DEVICE_COLL=use,
                    **{f"{c}_ALGO": forced for c in _ALGOS})
                for name in ("allreduce", "bcast", "allgather",
                             "alltoallv"):
                    for nbytes in (0, 1000, 16383, 16384, 1 << 20):
                        for bname, (pbuf, jbuf) in bufs.items():
                            for oname in (("sum", "user")
                                          if name == "allreduce"
                                          else (None,)):
                                pop, jop_ = ops[oname] if oname else \
                                    (None, None)
                                want = jax_device._select_transport(
                                    None, name, nbytes, jop_, jbuf)
                                got = port_device._select_transport(
                                    name, nbytes, pop, pbuf)
                                assert got == want, (
                                    min_bytes, use, forced, name, nbytes,
                                    bname, oname)
                                cases += 1
    assert cases == 3 * 2 * 3 * (5 * 3 * 2 + 3 * 5 * 3)


def test_host_buffers_below_the_crossover(env):
    """A numpy buffer below DEVICE_COLL_MIN_BYTES (16 KiB) takes the host
    tier, as in the JAX package, with its bits and the same host
    algorithm counted; at 16 KiB, or as a tensor, it runs on the device,
    bitwise the JAX channel's result."""
    from mvapich2_tpu import mpit as jax_mpit
    for c in _ALGOS:
        env(**{f"{c}_ALGO": None})
    small = _inputs(98, 4095, "intf32")          # 16 KiB - 4 a rank
    big = _inputs(99, 4096, "intf32")            # 16 KiB a rank
    rd = "coll_allreduce_allreduce_recursive_doubling_calls"
    before = _counts()
    p0, j0 = mpit.pvar(rd).read(), jax_mpit.pvar(rd).read()
    mine, ref = _both(lambda c, ops: c.allreduce(small[c.rank].copy()))
    _check(mine, ref, True)
    assert _counts() == before
    assert mpit.pvar(rd).read() - p0 == jax_mpit.pvar(rd).read() - j0 == NP

    def app(comm, ops):
        r = comm.rank
        return (comm.allreduce(big[r].copy()),
                comm.allreduce(torch.from_numpy(small[r].copy())
                               if isinstance(ops.SUM, top.Op) else
                               small[r].copy()))

    mine = run_ranks(NP, app, top, device_mesh=make_mesh((NP,), ("x",),
                                                         "cpu"))
    assert _counts() != before
    env(**{f"{c}_ALGO": "device" for c in _ALGOS})
    ref = jax_run_ranks(NP, lambda comm: app(comm, jop),
                        device_mesh=jax_make_mesh((NP,), ("x",),
                                                  jax.devices()[:NP]))
    for (a, b), (c, d) in zip(mine, ref):
        np.testing.assert_array_equal(a, np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d))


@pytest.mark.parametrize("np_dtype", [np.uint16, np.uint32])
def test_unsigned_collectives_match_jax(env, np_dtype):
    """uint16 and uint32 run on the device, as in the JAX package: sums
    that wrap, max and min past 2^15 / 2^31, an allgather; bitwise the
    JAX channel's results."""
    info = np.iinfo(np_dtype)
    rng = np.random.default_rng(int(info.bits))
    data = rng.integers(info.max // 2, info.max, size=(NP, 64),
                        endpoint=True).astype(np_dtype)

    def app(comm, ops):
        r = comm.rank
        return (comm.allreduce(data[r].copy()),              # K6
                comm.allreduce(data[r][:61].copy()),         # K3
                comm.allreduce(data[r].copy(), op=ops.MAX),
                comm.allreduce(data[r].copy(), op=ops.MIN),
                comm.allgather(data[r][:5].copy()))

    mine, ref = _both(app)
    for got, want in zip(mine, ref):
        for g, w in zip(got, want):
            assert g.dtype == np_dtype
            np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(
        mine[0][0], (data.astype(np.uint64).sum(0) % (info.max + 1))
        .astype(np_dtype))


@pytest.mark.parametrize("forced", ["device", None])
def test_bf16_allreduce_takes_the_reference_tier(env, monkeypatch, forced):
    """A bfloat16 allreduce on the 1:1 channel goes where the JAX channel
    sends it: ml_dtypes' bfloat16 (numpy kind 'V') does not lower, so
    the JAX package takes its host tier, forced <COLL>_ALGO=device or
    not, and so does the port for a CPU tensor: it is read as ml_dtypes'
    bfloat16, folded there, and comes back as a bfloat16 tensor with the
    JAX package's bits, no ring launched. A bfloat16 tensor on the card
    (the meta device stands in for it) raises NotImplementedError on
    every rank instead of moving to the host."""
    import jax.numpy as jnp
    from mvapich2_tpu.coll import device as jax_device
    env(**{f"{c}_ALGO": forced for c in _ALGOS})
    data = np.random.default_rng(100).integers(
        -8, 8, size=(NP, 8192)).astype(jnp.bfloat16)        # 16 KiB a rank
    seen = []
    select = jax_device._select_transport

    def spy(*a, **kw):
        seen.append(select(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(jax_device, "_select_transport", spy)
    ref = jax_run_ranks(NP, lambda comm: comm.allreduce(
        data[comm.rank].copy()), device_mesh=jax_make_mesh(
            (NP,), ("x",), jax.devices()[:NP]))
    assert seen == ["host"] * NP
    np.testing.assert_array_equal(np.asarray(ref[0], np.float32),
                                  data.astype(np.float32).sum(0))
    before = _counts()
    mine = run_ranks(NP, lambda c, ops: c.allreduce(torch.from_numpy(
        data[c.rank].astype(np.float32)).to(torch.bfloat16)), top,
        device_mesh=make_mesh((NP,), ("x",), "cpu"), timeout=30)
    assert _counts() == before
    for got, want in zip(mine, ref):
        assert got.dtype == torch.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == \
            np.asarray(want).tobytes()

    def on_card(c, ops):
        with pytest.raises(NotImplementedError, match="bfloat16"):
            c.allreduce(torch.empty(8192, dtype=torch.bfloat16,
                                    device="meta"))
        return True
    assert run_ranks(NP, on_card, top, device_mesh=make_mesh(
        (NP,), ("x",), "cpu"), timeout=30) == [True] * NP
    assert _counts() == before
