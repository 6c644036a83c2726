"""Parity of the port's nonblocking and persistent device collectives
(mvapich2_tpu_torch core/request.py, coll/nbc, coll/nonblocking.py and
DeviceCollChannel.nonblocking / _nb_* in coll/device.py) with the JAX
package's device NBC tier, on the same seeded numpy inputs:

* iallreduce, ibcast, iallgather, ialltoall and ialltoallv on the 1:1
  mesh channel (here on the CPU, so the kernel wrappers take their plain
  versions), segmented at DEVICE_NBC_SEG_BYTES=256, held bitwise against
  the JAX package's i-collectives (run_ranks(p, app, device_mesh=...))
  and against the port's blocking path; the deltas of dev_nbc_segments,
  nbc_vertices_issued, dev_coll_tier_* and coll_level_* held equal to
  the JAX package's (a segment counts no tier and no level);
* the persistent allreduce_init / alltoallv_init starts and
  dev_persistent_starts; prewarm;
* the calls the JAX package sends to its host schedule, which count
  dev_coll_fallback_nbc as there and raise NotImplementedError; a rank
  that dies, and a segment that fails, make every peer's wait() raise;
* a traced iallreduce: the nbc- and device-lane events against the JAX
  package's, lat_dev_nbc under MV2T_METRICS=1 and 0, and the JAX
  package's conformance checker on the port's dumps.

Integer data throughout, so every comparison is bitwise. Every MV2T_*
change is restored and both configs reloaded in the ``env`` fixture's
teardown, which also restores both packages' ``metrics.LIVE`` and leaves
no recorder or ``mpi`` wrapper of either package installed."""

import collections
import glob
import json
import os
import threading
import time

import numpy as np
import pytest

import jax
import torch

from mvapich2_tpu import autotune as jax_autotune
from mvapich2_tpu import metrics as jax_metrics
from mvapich2_tpu import mpit as jax_mpit
from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.analysis import conform
from mvapich2_tpu.coll import tuning as jax_tuning  # noqa: F401 - declares the <COLL>_ALGO cvars
from mvapich2_tpu.core import request as jax_request
from mvapich2_tpu.coll.api import IN_PLACE as JAX_IN_PLACE
from mvapich2_tpu.core.errors import MPIException as JaxMPIException
from mvapich2_tpu.ops import pallas_ici, pallas_ring
from mvapich2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mvapich2_tpu.trace import recorder as jax_recorder
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import make_mesh, metrics, mpit, run_ranks, trace
from mvapich2_tpu_torch.coll import device as devmod
from mvapich2_tpu_torch.core import op as top
from mvapich2_tpu_torch.core import request
from mvapich2_tpu_torch.core.comm import IN_PLACE, Comm
from mvapich2_tpu_torch.core.errors import (MPI_ERR_INTERN,
                                            MPIX_ERR_PROC_FAILED,
                                            MPIException)
from mvapich2_tpu_torch.trace import recorder
from mvapich2_tpu_torch.utils.config import get_config

SEG = 256          # DEVICE_NBC_SEG_BYTES: 512 int32 -> 8 segments of 64
N = 512
PVARS = ("dev_nbc_segments", "nbc_vertices_issued", "dev_coll_tier_vmem",
         "dev_coll_tier_hbm", "dev_coll_tier_quant", "coll_level_chip",
         "coll_level_ici", "dev_coll_fallback_nbc", "dev_persistent_starts")


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages and
    reloads both configs; host buffers of any size take the device and the
    JAX ring kernels run creditless. The teardown restores the
    environment, both configs and both ``metrics.LIVE`` gates, and checks
    that no recorder or ``mpi`` wrapper of either package is left."""
    monkeypatch.setattr(jax_autotune, "_default_attempted", True)
    monkeypatch.setattr(jax_tuning, "_DEVICE_CROSSOVERS", {})
    monkeypatch.setattr(jax_tuning, "_KERNEL_PARAMS", {})
    monkeypatch.setattr(pallas_ici, "have_remote_signal", lambda: False)
    monkeypatch.setattr(pallas_ring, "have_remote_signal", lambda: False)
    live = (metrics.LIVE, jax_metrics.LIVE)

    def set_env(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(f"MV2T_{k}", raising=False)
            else:
                monkeypatch.setenv(f"MV2T_{k}", str(v))
        jax_config().reload()
        get_config().reload()
    set_env(DEVICE_COLL_MIN_BYTES="1", DEVICE_NBC_SEG_BYTES=str(SEG))
    yield set_env
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()
    metrics.LIVE, jax_metrics.LIVE = live
    leaked = list(recorder._active) + list(jax_recorder._active)
    wrapped = hasattr(Comm.allreduce, "__wrapped__")
    trace._uninstall_mpi_tracer()
    recorder._active.clear()
    assert not leaked and not wrapped, "a recorder or mpi wrapper was left"


class _Lib:
    """What an app needs of either package."""

    def __init__(self, request_mod, exc):
        self.request = request_mod
        self.MPIException = exc


PORT = _Lib(request, MPIException)
JAX = _Lib(jax_request, JaxMPIException)


def _meshes(shape):
    axes = ("x", "y")[:len(shape)]
    ndev = int(np.prod(shape))
    return (make_mesh(shape, axes, "cpu"),
            jax_make_mesh(shape, axes, jax.devices()[:ndev]))


def _deltas(mod, run):
    before = {k: mod.pvar(k).read() for k in PVARS}
    out = run()
    return out, {k: mod.pvar(k).read() - before[k] for k in PVARS}


def _both(nranks, app, shape=None):
    """``app(comm, lib)`` on both packages over a mesh of ``shape``
    (default: 1-D, one device a rank); returns (port results, JAX results,
    port pvar deltas, JAX pvar deltas)."""
    pm, jm = _meshes(shape or (nranks,))
    mine, pd = _deltas(mpit, lambda: run_ranks(nranks, app, PORT,
                                               device_mesh=pm))
    ref, jd = _deltas(jax_mpit, lambda: jax_run_ranks(
        nranks, lambda comm: app(comm, JAX), device_mesh=jm))
    return mine, ref, pd, jd


def _blocking(nranks, app, shape=None):
    pm, _ = _meshes(shape or (nranks,))
    return run_ranks(nranks, app, device_mesh=pm)


def _ints(seed, rank, n, dtype=np.int32):
    rng = np.random.default_rng(seed * 100 + rank)
    return rng.integers(-1000, 1000, size=n).astype(dtype)


def _count_matrix(p, shape):
    """The count matrices of tests/test_device_nbc.py."""
    if shape == "uniform":
        return [[3] * p for _ in range(p)]
    if shape == "zero":                 # rank 0 sends nothing at all
        return [[0] * p if i == 0 else [(i + j) % 4 for j in range(p)]
                for i in range(p)]
    return [[(i + 2 * j) % 3 for j in range(p)] for i in range(p)]


def _v_bufs(p, r, counts, dtype=np.int32):
    scounts = list(counts[r])
    rcounts = [counts[j][r] for j in range(p)]
    send = np.concatenate(
        [np.arange(r * 1000 + j * 100, r * 1000 + j * 100 + c)
         for j, c in enumerate(scounts)] or [np.zeros(0)]).astype(dtype)
    return send, scounts, rcounts


def _check(mine, ref, blocking=None):
    for r, (got, want) in enumerate(zip(mine, ref)):
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        if blocking is not None:
            np.testing.assert_array_equal(got, blocking[r],
                                          err_msg=f"rank {r} (blocking)")


def _same_counts(pd, jd, **want):
    assert pd == jd, f"port {pd} != JAX {jd}"
    for k, v in want.items():
        assert pd[k] == v, (k, pd[k], v)


# ---------------------------------------------------------------------------
# the i-collectives, bitwise against the JAX package and the blocking path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 4, 8])
def test_iallreduce_segments_match_jax(env, p):
    """512 int32 at 256-byte segments: 8 segments, one launch each, a
    compute between the call and its wait(); the result bitwise the JAX
    package's iallreduce and the port's blocking allreduce."""
    def app(comm, lib):
        x = _ints(1, comm.rank, N)
        out = np.zeros_like(x)
        req = comm.iallreduce(x, out)
        busy = (x * 2).sum()            # the overlapped compute
        req.wait()
        return out, req.device_nbc, int(busy)

    mine, ref, pd, jd = _both(p, app)
    blocking = _blocking(p, lambda comm: comm.allreduce(_ints(1, comm.rank,
                                                              N)))
    assert all(m[1] for m in mine) and all(r[1] for r in ref)
    _check([m[0] for m in mine], [r[0] for r in ref], blocking)
    _same_counts(pd, jd, dev_nbc_segments=8, dev_coll_tier_vmem=0,
                 coll_level_ici=0, nbc_vertices_issued=p * 10)


def _app_for(case, p):
    """(app, the same call blocking) of one case."""
    if case in ("ibcast", "unaligned", "mesh24"):
        n = 1001 if case == "unaligned" else N

        def app(comm, lib):
            if case == "ibcast":
                buf = _ints(3, comm.rank, n) if comm.rank == 2 else \
                    np.zeros(n, np.int32)
                req = comm.ibcast(buf, root=2)
            else:
                x = _ints(4, comm.rank, n)
                buf = np.zeros_like(x)
                req = comm.iallreduce(x, buf)
            req.wait()
            return buf, req.device_nbc

        def blocking(comm):
            if case == "ibcast":
                return comm.bcast(_ints(3, comm.rank, n) if comm.rank == 2
                                  else np.zeros(n, np.int32), root=2)
            return comm.allreduce(_ints(4, comm.rank, n))
        return app, blocking
    if case in ("iallgather", "ialltoall"):
        def app(comm, lib):
            x = _ints(5, comm.rank, 6 * p)
            out = np.zeros(6 * p if case == "ialltoall" else 6 * p * p,
                           np.int32)
            req = (comm.ialltoall(x, out) if case == "ialltoall"
                   else comm.iallgather(x, out))
            req.wait()
            return out, req.device_nbc

        def blocking(comm):
            x = _ints(5, comm.rank, 6 * p)
            return comm.alltoall(x) if case == "ialltoall" \
                else comm.allgather(x)
        return app, blocking
    shape = case.split("-")[1]

    def app(comm, lib):
        send, sc, rc = _v_bufs(p, comm.rank, _count_matrix(p, shape))
        out = np.full(max(1, sum(rc)), -7, np.int32)
        req = comm.ialltoallv(send, sc, None, out, rc, None)
        req.wait()
        return out, req.device_nbc

    def blocking(comm):
        send, sc, rc = _v_bufs(p, comm.rank, _count_matrix(p, shape))
        out = np.full(max(1, sum(rc)), -7, np.int32)
        comm.alltoallv(send, sc, None, out, rc, None)
        return out
    return app, blocking


@pytest.mark.parametrize("case,segs", [
    ("ibcast", 8), ("iallgather", 1), ("ialltoall", 1),
    ("ialltoallv-uniform", 1), ("ialltoallv-skew", 1),
    ("ialltoallv-zero", 1),
    # 1001 int32 at 256 bytes: 8 segments of 126 (119 last), each after
    # the first at an offset that is not 16-byte aligned
    ("unaligned", 8),
    # the (2, 4) mesh: each segment the multi-axis program
    ("mesh24", 8)])
def test_icollectives_match_jax(env, case, segs):
    p = 8 if case == "mesh24" else 4
    shape = (2, 4) if case == "mesh24" else None
    app, blocking = _app_for(case, p)
    mine, ref, pd, jd = _both(p, app, shape)
    assert all(m[1] for m in mine) and all(r[1] for r in ref)
    _check([m[0] for m in mine], [r[0] for r in ref],
           _blocking(p, blocking, shape))
    _same_counts(pd, jd, dev_nbc_segments=segs, dev_coll_tier_hbm=0,
                 coll_level_ici=0)


def test_unaligned_segments_are_views_at_odd_offsets(env):
    """The segmentation of the unaligned case: 8 segments, 126 elements
    apart, so segment 1 starts 504 bytes in (not a multiple of 16)."""
    ch = devmod.DeviceCollChannel(make_mesh((4,), ("x",), "cpu"),
                                  devmod._Rendezvous(4), 0)
    segs = ch._nb_segments("allreduce", 1001, torch.int32)
    assert segs == [(o, min(126, 1001 - o)) for o in range(0, 1001, 126)]
    assert segs[1][0] * 4 % 16 == 8
    assert ch._nb_segments("allgather", 1001, torch.int32) == [(0, 1001)]


def test_waitall_testall_three_in_flight(env):
    """Three calls in flight at once, completed through testall polling
    and waitall (each package's own), land as the JAX package's."""
    p = 4

    def app(comm, lib):
        x = _ints(6, comm.rank, N)
        a, b = np.zeros_like(x), np.zeros(4 * p, np.int32)
        g = np.zeros(3 * p, np.int32)
        reqs = [comm.iallreduce(x, a),
                comm.ialltoall(_ints(7, comm.rank, 4 * p), b),
                comm.iallgather(_ints(8, comm.rank, 3), g)]
        polls = 0
        while not lib.request.testall(reqs) and polls < 3:
            polls += 1
        lib.request.waitall(reqs)
        assert lib.request.testall(reqs)
        return np.concatenate([a, b, g]), all(r.device_nbc for r in reqs)

    mine, ref, pd, jd = _both(p, app)
    assert all(m[1] for m in mine)
    _check([m[0] for m in mine], [r[0] for r in ref])
    _same_counts(pd, jd, dev_nbc_segments=8 + 1 + 1)


# ---------------------------------------------------------------------------
# persistent collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coll", ["allreduce", "alltoallv"])
def test_persistent_starts_match_jax(env, coll):
    """allreduce_init (3 starts) and alltoallv_init (2 starts) land as
    the JAX package's, and dev_persistent_starts moves by the same count;
    the allreduce's init built every segment program on every rank, the
    alltoallv's none (its count matrix is cross-rank state)."""
    p, starts = 4, 3 if coll == "allreduce" else 2

    def app(comm, lib):
        if coll == "allreduce":
            x = _ints(9, comm.rank, N)
            out = np.zeros_like(x)
            req = comm.allreduce_init(x, out)
        else:
            send, sc, rc = _v_bufs(p, comm.rank, _count_matrix(p, "skew"))
            out = np.zeros(sum(rc), np.int32)
            req = comm.alltoallv_init(send, sc, None, out, rc, None)
        built = after = None
        if lib is PORT:
            built = set(comm.device_channel._programs)
        got = []
        for _ in range(starts):
            out[:] = -1
            req.start()
            req.wait()
            got.append(out.copy())
        req.free()
        if lib is PORT:
            after = set(comm.device_channel._programs)
        return np.concatenate(got), built, after

    mine, ref, pd, jd = _both(p, app)
    _check([m[0] for m in mine], [r[0] for r in ref])
    # the 8 segments share one signature (64 elements); a start builds
    # nothing more, on whichever rank launches
    want = [64] if coll == "allreduce" else []
    for _, built, after in mine:
        assert sorted(k[1] for k in built) == want, built
        if coll == "allreduce":
            assert after == built
        else:
            assert {k[0] for k in after} <= {"alltoallv"}
    segs = 8 if coll == "allreduce" else 1
    _same_counts(pd, jd, dev_persistent_starts=p * starts,
                 dev_nbc_segments=segs * starts)


def test_prewarm(env):
    """prewarm_persistent builds the allreduce's segment programs and
    returns True; for alltoallv it returns False and builds nothing."""
    def app(comm):
        x = np.zeros(N, np.int32)
        ok = devmod.prewarm_persistent(comm, "allreduce", x,
                                       np.zeros_like(x), N, x.dtype,
                                       top.SUM)
        keys = set(comm.device_channel._programs)
        ok_v = devmod.prewarm_persistent(
            comm, "alltoallv", x[:4], [1] * 4, None, np.zeros(4, np.int32),
            [1] * 4, None, x.dtype)
        return ok, keys, ok_v, set(comm.device_channel._programs) == keys

    for ok, keys, ok_v, same in _blocking(4, app):
        assert ok and not ok_v and same
        assert {(k[0], k[1]) for k in keys} == {("allreduce", 64)}


# ---------------------------------------------------------------------------
# fallbacks and failures
# ---------------------------------------------------------------------------

def _fallback_app(case):
    def app(comm, lib):
        x = np.arange(64, dtype=np.int32) + comm.rank
        try:
            if case == "float64":
                req = comm.iallreduce(x.astype(np.float64),
                                      np.zeros(64, np.float64))
            elif case == "in_place":
                buf = x.copy()
                req = comm.iallreduce(IN_PLACE if lib is PORT else
                                      JAX_IN_PLACE, buf)
            elif case == "tensor_recvbuf":
                recv = (torch.zeros(64, dtype=torch.int32) if lib is PORT
                        else jax.numpy.zeros(64, np.int32))
                req = comm.iallreduce(x, recv)
            else:                       # the slot and fold channels
                req = comm.iallreduce(x, np.zeros_like(x))
            req.wait()
        except NotImplementedError as e:
            return "raised", str(e)
        except Exception as e:          # noqa: BLE001 - the JAX host path
            return "host", repr(e)
        return "host", getattr(req, "device_nbc", False)
    return app


@pytest.mark.parametrize("case", ["float64", "in_place", "tensor_recvbuf",
                                  "slot", "fold"])
def test_nonroutable_icoll_counts_fallback(env, case):
    """What the JAX package sends to its host schedule counts
    dev_coll_fallback_nbc on every rank, as there, and raises
    NotImplementedError in the port."""
    p = 4
    shape = {"slot": (1,), "fold": (2,)}.get(case, (p,))
    pm, jm = _meshes(shape)
    mine, pd = _deltas(mpit, lambda: run_ranks(p, _fallback_app(case), PORT,
                                               device_mesh=pm))
    ref, jd = _deltas(jax_mpit, lambda: jax_run_ranks(
        p, lambda comm: _fallback_app(case)(comm, JAX), device_mesh=jm))
    assert all(m[0] == "raised" and "host NBC schedule" in m[1]
               for m in mine), mine
    assert all(r[0] == "host" for r in ref), ref
    assert pd["dev_coll_fallback_nbc"] == jd["dev_coll_fallback_nbc"] == p
    assert pd["dev_nbc_segments"] == 0


def test_host_schedule_icolls_raise(env):
    """ireduce, ireduce_scatter_block, ibarrier and their persistent
    twins run on the JAX package's host schedule: they raise, count
    nothing."""
    def app(comm):
        x = np.zeros(N, np.int32)
        out = []
        for call in (lambda: comm.ireduce(x, np.zeros_like(x)),
                     lambda: comm.ireduce_scatter_block(x, np.zeros(
                         N // 4, np.int32)),
                     comm.ibarrier, comm.barrier_init,
                     lambda: comm.reduce_init(x, np.zeros_like(x))):
            with pytest.raises(NotImplementedError, match="host NBC"):
                call()
            out.append(True)
        return out

    before = mpit.pvar("dev_coll_fallback_nbc").read()
    assert all(all(r) for r in _blocking(4, app))
    assert mpit.pvar("dev_coll_fallback_nbc").read() == before


@pytest.mark.parametrize("when", ["parked", "before_post", "persistent"])
def test_dead_rank_fails_peers_wait(env, when):
    """A rank that raises (while its peers wait in an iallreduce, before
    it posts, or before a persistent restart) makes every peer's wait()
    raise MPIX_ERR_PROC_FAILED within seconds, far inside run_ranks'
    timeout; no schedule is left active."""
    p, victim, outcome = 4, 2, {}

    def app(comm):
        x = np.arange(64, dtype=np.int32)
        out = np.zeros_like(x)
        if when == "persistent":
            req = comm.allreduce_init(x, out)
            req.start()
            req.wait()
        if comm.rank == victim:
            time.sleep(0.3 if when != "before_post" else 0.0)
            raise RuntimeError("the victim dies")
        if when == "before_post":
            time.sleep(0.3)
        t0 = time.perf_counter()
        try:
            if when == "persistent":
                req.start()
            else:
                req = comm.iallreduce(x, out)
            req.wait()
            outcome[comm.rank] = "completed"
        except MPIException as e:
            outcome[comm.rank] = (e.error_class, time.perf_counter() - t0)

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="the victim dies"):
        run_ranks(p, app, device_mesh=make_mesh((p,), ("x",), "cpu"),
                  timeout=60)
    assert time.perf_counter() - t0 < 10
    assert sorted(outcome) == [r for r in range(p) if r != victim]
    assert all(v[0] == MPIX_ERR_PROC_FAILED and v[1] < 5
               for v in outcome.values()), outcome
    assert mpit.pvar("nbc_scheds_active").read() == 0


def test_failed_segment_raises_on_every_rank(env, monkeypatch):
    """A segment whose program raises (a kernel that fails to build or
    launch) raises out of every rank's wait(), with the cause kept."""
    def broken(self, *a, **k):
        def f(xs, root):
            raise RuntimeError("the kernel did not launch")
        return f
    monkeypatch.setattr(devmod.DeviceCollChannel, "_program", broken)

    def app(comm):
        x = np.arange(N, dtype=np.int32)
        req = comm.iallreduce(x, np.zeros_like(x))
        with pytest.raises(MPIException) as ei:
            req.wait()
        return ei.value.error_class, repr(ei.value.__cause__)

    for cls, cause in _blocking(4, app):
        assert cls == MPI_ERR_INTERN and "did not launch" in cause
    assert mpit.pvar("nbc_scheds_active").read() == 0


def test_wait_sleeps_on_the_doorbell(env):
    """A rank parked in wait() is woken by its last peer's deposit, not
    by spinning: the engine's doorbell is the rendezvous's, and the
    wakeups counter moves."""
    p = 2
    w0 = mpit.pvar("nbc_wakeups").read()

    def app(comm):
        assert comm.u.engine.bell is comm.device_channel.rv.nb_bell
        x = np.arange(N, dtype=np.int32)
        out = np.zeros_like(x)
        if comm.rank == 1:
            time.sleep(0.2)
        req = comm.iallreduce(x, out)
        req.wait()
        return out

    for out in _blocking(p, app):
        np.testing.assert_array_equal(out, np.arange(N) * p)
    assert mpit.pvar("nbc_wakeups").read() > w0


# ---------------------------------------------------------------------------
# trace and metrics
# ---------------------------------------------------------------------------

def _dump_events(d):
    out = []
    for path in sorted(glob.glob(os.path.join(str(d), "trace-r*.json"))):
        with open(path) as f:
            snap = json.load(f)
        out += [(snap["rank"], *ev[1:]) for ev in snap["events"]]
    assert out, f"no dump under {d}"
    return out


def _nbc_sig(events):
    """nbc lane: a multiset per rank, the schedule ids aside."""
    return collections.Counter(
        (r, name, ph, tuple(sorted((k, v) for k, v in (a or {}).items()
                                   if k != "sched")))
        for r, layer, name, ph, a in events if layer == "nbc")


def _seg_sig(events):
    """The segment instants: a multiset over all ranks (whichever rank
    launched or first saw a segment records it), ``us`` aside."""
    return collections.Counter(
        (name, tuple(sorted((k, v) for k, v in a.items() if k != "us")))
        for r, layer, name, ph, a in events
        if layer == "device" and name.startswith("nbc_dev_"))


def _tier_set(events):
    return {(name, tuple(sorted(a.items())))
            for r, layer, name, ph, a in events
            if layer == "device" and name.startswith("ici_")}


def _mpi_sig(events):
    return collections.Counter((r, name, ph) for r, layer, name, ph, a
                               in events if layer == "mpi")


def test_traced_iallreduce_matches_jax(env, tmp_path):
    """One traced iallreduce (4 ranks, 8 segments, the JAX ring kernels in
    interpret mode): the same nbc-lane events on every rank, the same
    segment instants and tier instants, the same mpi-lane spans;
    lat_dev_nbc moves by 8 in both packages; the port's dumps pass the
    JAX package's conformance checker."""
    p = 4

    def app(comm, lib):
        x = _ints(11, comm.rank, N)
        out = np.zeros_like(x)
        comm.iallreduce(x, out).wait()
        return out

    env(ICI_INTERPRET="1", METRICS="1")
    pm, jm = _meshes((p,))
    metrics.ensure_live()
    sigs, hist = {}, {}
    for name, run, mod in (
            ("port", lambda: run_ranks(p, app, PORT, device_mesh=pm), mpit),
            ("jax", lambda: jax_run_ranks(
                p, lambda comm: app(comm, JAX), device_mesh=jm), jax_mpit)):
        d = tmp_path / name
        env(TRACE="1", TRACE_DIR=str(d))
        c0 = mod.pvar("lat_dev_nbc").count
        res = run()
        env(TRACE=None, TRACE_DIR=None)
        hist[name] = mod.pvar("lat_dev_nbc").count - c0
        sigs[name] = (_dump_events(d), res)
    (pe, pres), (je, jres) = sigs["port"], sigs["jax"]
    _check(pres, jres)
    assert hist == {"port": 8, "jax": 8}
    assert _nbc_sig(pe) == _nbc_sig(je)
    assert _seg_sig(pe) == _seg_sig(je)
    assert sum(_seg_sig(pe).values()) == 16
    assert _tier_set(pe) == _tier_set(je) and _tier_set(pe)
    assert _mpi_sig(pe) == _mpi_sig(je)
    paths = sorted(glob.glob(os.path.join(str(tmp_path / "port"),
                                          "trace-r*.json")))
    events, ranks, truncated = conform.load_dumps(paths)
    assert not truncated
    violations = conform.check_events(events, ranks=ranks)
    assert violations == [], conform.render(violations, len(events))


def test_lat_dev_nbc_gated_off(env):
    """MV2T_METRICS=0: neither package arms its gate, and lat_dev_nbc
    records nothing in either."""
    env(METRICS="0")
    metrics.LIVE = jax_metrics.LIVE = None

    def app(comm, lib):
        x = np.ones(N, np.int32)
        comm.iallreduce(x, np.zeros_like(x)).wait()
        return x

    c0 = (mpit.pvar("lat_dev_nbc").count, jax_mpit.pvar("lat_dev_nbc").count)
    _both(2, app)
    assert (mpit.pvar("lat_dev_nbc").count,
            jax_mpit.pvar("lat_dev_nbc").count) == c0
    assert metrics.LIVE is None


def test_engine_wait_releases_the_gil(env):
    """While a rank waits for a peer that has not posted, other Python
    threads keep running (the wait sleeps on the doorbell)."""
    ticks = []
    stop = threading.Event()

    def ticker():
        while not stop.is_set():
            ticks.append(1)
            time.sleep(0.001)

    def app(comm):
        x = np.arange(N, dtype=np.int32)
        if comm.rank == 1:
            time.sleep(0.3)
        comm.iallreduce(x, np.zeros_like(x)).wait()

    t = threading.Thread(target=ticker, daemon=True)
    t.start()
    try:
        _blocking(2, app)
    finally:
        stop.set()
        t.join()
    assert len(ticks) > 50


def test_stress_many_calls_in_flight(env):
    """More rank threads than cores, 12 calls in flight a rank, a short
    interpreter switch interval: every result lands, every segment is
    launched once, and no call record or schedule is left behind."""
    import sys
    p, calls = min(16, max(8, (os.cpu_count() or 1) + 1)), 12
    seg0 = mpit.pvar("dev_nbc_segments").read()
    rvs = []

    def app(comm):
        rvs.append(comm.device_channel.rv)
        xs = [_ints(20 + i, comm.rank, N) for i in range(calls)]
        outs = [np.zeros_like(x) for x in xs]
        reqs = [comm.iallreduce(x, o) for x, o in zip(xs, outs)]
        request.waitall(reqs)
        return outs

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        res = run_ranks(p, app, device_mesh=make_mesh((p,), ("x",), "cpu"),
                        timeout=60)
    finally:
        sys.setswitchinterval(old)
    for i in range(calls):
        want = sum(_ints(20 + i, r, N) for r in range(p))
        for r in range(p):
            np.testing.assert_array_equal(res[r][i], want)
    assert mpit.pvar("dev_nbc_segments").read() - seg0 == 8 * calls
    assert rvs[0].nb_calls == {} and mpit.pvar("nbc_scheds_active").read() == 0
