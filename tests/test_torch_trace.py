"""Parity of the port's trace and metric hooks (mvapich2_tpu_torch/trace,
metrics, and their sites in coll/device.py, ops/ici.py and rma/device.py)
with the JAX package's, on the same programs and the same numpy inputs:

* the slot channel (8 ranks on one device), the 1:1 mesh channel on 8
  virtual devices (the hbm, vmem and stock tiers), the fold channel (8
  ranks over 4 devices) and the (2, 4) mesh, each under MV2T_TRACE;
* a DeviceWin fence epoch and a lock/flush/unlock epoch.

Each rank's dump is reduced to the multiset of (rank, layer, name, phase,
argument keys, argument values but the ``us`` time) and held equal to
the JAX package's; the ``lat_dev_<tier>`` and ``lat_rma_flush``
histograms must move by the same counts. The JAX ring kernels run in
interpret mode, creditless (``have_remote_signal`` patched to False). On
the (2, 4) mesh the JAX interpreter sends each phase to the stock
lowering before its ``ici_<coll>`` instant; the port takes the JAX
hardware branch (``ops/ici.py`` ``_mesh_mode``), so its per-phase
instants are checked against what that branch records. The port's dumps
go through the JAX package's ``analysis/conform.check_events`` and
``trace/perfetto.merge_dir``.

Every MV2T_* change is restored and both configs reloaded in the
``env`` fixture's teardown, which also leaves no port recorder and no
``mpi`` wrapper installed."""

import collections
import glob
import json
import os

import numpy as np
import pytest

import jax
import torch

from mvapich2_tpu import autotune as jax_autotune
from mvapich2_tpu import mpit as jax_mpit
from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.analysis import conform
from mvapich2_tpu.coll import tuning as jax_tuning  # noqa: F401 - declares the <COLL>_ALGO cvars
from mvapich2_tpu.ops import pallas_ici, pallas_ring
from mvapich2_tpu.parallel import MeshComm as JaxMeshComm
from mvapich2_tpu.parallel import make_mesh as jax_make_mesh
from mvapich2_tpu.rma.device import DeviceWin as JaxDeviceWin
from mvapich2_tpu.trace import perfetto
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import make_mesh, metrics, mpit, run_ranks, trace
from mvapich2_tpu_torch.coll import device as devmod
from mvapich2_tpu_torch.core.comm import Comm
from mvapich2_tpu_torch.parallel import MeshComm
from mvapich2_tpu_torch.rma import DeviceWin
from mvapich2_tpu_torch.trace import recorder
from mvapich2_tpu_torch.utils.config import get_config

NP = 8
N = 4096                  # f32 elements a rank: 16 KiB
HISTS = ("lat_dev_vmem", "lat_dev_hbm", "lat_dev_xla", "lat_dev_slot",
         "lat_rma_flush")


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages (and
    reloads both configs); every collective is forced onto the device and
    the JAX ring kernels run creditless. The teardown restores the
    environment, reloads both configs and checks that no port recorder or
    ``mpi`` wrapper is left."""
    monkeypatch.setattr(jax_autotune, "_default_attempted", True)
    monkeypatch.setattr(jax_tuning, "_DEVICE_CROSSOVERS", {})
    monkeypatch.setattr(jax_tuning, "_KERNEL_PARAMS", {})
    monkeypatch.setattr(pallas_ici, "have_remote_signal", lambda: False)
    monkeypatch.setattr(pallas_ring, "have_remote_signal", lambda: False)

    def set_env(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(f"MV2T_{k}", raising=False)
            else:
                monkeypatch.setenv(f"MV2T_{k}", str(v))
        jax_config().reload()
        get_config().reload()
    set_env(ALLREDUCE_ALGO="device")
    yield set_env
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()
    leaked = list(recorder._active)
    wrapped = hasattr(Comm.allreduce, "__wrapped__")
    trace._uninstall_mpi_tracer()
    recorder._active.clear()
    assert not leaked and not wrapped, "a recorder or mpi wrapper was left"


def _counts(mod):
    return {h: mod.pvar(h).count for h in HISTS}


def _traced(env, d, run, mod):
    """``run()`` under MV2T_TRACE with dumps into ``d``; returns the
    counts it added to the histograms of ``mod`` (either package's
    mpit)."""
    env(TRACE="1", TRACE_DIR=str(d))
    before = _counts(mod)
    run()
    env(TRACE=None, TRACE_DIR=None)
    return {h: c - before[h] for h, c in _counts(mod).items()}


def _dumps(d):
    paths = sorted(glob.glob(os.path.join(str(d), "trace-r*.json")))
    assert paths, f"no dump under {d}"
    out = []
    for p in paths:
        with open(p) as f:
            snap = json.load(f)
        assert sorted(snap) == ["capacity", "clock", "events", "rank"]
        assert snap["clock"] == "monotonic"
        assert os.path.basename(p) == f"trace-r{snap['rank']}.json"
        out.append(snap)
    return out


def _key(rank, layer, name, ph, args):
    args = args or {}
    return (rank, layer, name, ph, tuple(sorted(args)),
            tuple(sorted((k, v) for k, v in args.items() if k != "us")))


def _signature(d):
    """The multiset of every event of every rank, times left out."""
    return collections.Counter(_key(s["rank"], *ev[1:])
                               for s in _dumps(d) for ev in s["events"])


def _check_port_dumps(d):
    """The port's dumps pass the JAX package's conformance automata and
    merge into one trace-event JSON."""
    paths = sorted(glob.glob(os.path.join(str(d), "trace-r*.json")))
    events, ranks, truncated = conform.load_dumps(paths)
    assert events and not truncated
    violations = conform.check_events(events, ranks=ranks)
    assert violations == [], conform.render(violations, len(events))
    merged = perfetto.merge_dir(str(d))
    spans = [e for e in merged["traceEvents"] if e.get("ph") in "BEi"]
    assert len(spans) == len(events)


def _allreduces(with_max=False):
    """Two sum allreduces of N f32 a rank (and a max: the stock reduction
    on the slot channel); ``ops`` is the package's core.op."""
    def app(comm, ops=None):
        x = (np.arange(N) % 13 + comm.rank).astype(np.float32)
        comm.allreduce(x)
        comm.allreduce(x + 1)
        if with_max:
            comm.allreduce(x, op=ops.MAX)
    return app


def _both(env, tmp_path, nranks, shape, app, **kw):
    """``app`` on both packages over a mesh of ``shape`` (None: the slot
    channel); returns the two dump directories and histogram deltas."""
    from mvapich2_tpu.core import op as jop
    from mvapich2_tpu_torch.core import op as top
    axes = ("x", "y")[:len(shape)] if shape and len(shape) > 1 else ("x",)
    if shape is None:
        mine = dict(device="cpu")
        ref = dict(device_mesh=jax_make_mesh((1,), ("x",),
                                             jax.devices()[:1]))
    else:
        ndev = int(np.prod(shape))
        mine = dict(device_mesh=make_mesh(shape, axes, "cpu"))
        ref = dict(device_mesh=jax_make_mesh(shape, axes,
                                             jax.devices()[:ndev]))
    env(**kw)
    pd, jd = tmp_path / "port", tmp_path / "jax"
    ph = _traced(env, pd, lambda: run_ranks(nranks, app, top, **mine), mpit)
    jh = _traced(env, jd, lambda: jax_run_ranks(
        nranks, lambda comm: app(comm, jop), **ref), jax_mpit)
    return pd, jd, ph, jh


@pytest.mark.parametrize("case", ["slot", "mesh_hbm", "mesh_vmem",
                                  "mesh_xla", "fold"])
def test_collective_events_match_jax(env, tmp_path, case):
    """Slot, 1-D mesh (K3, K6 and the stock lowering past
    DEV_TIER_XLA_MIN) and fold allreduces: the same events, argument keys
    and values on every rank, the same histogram counts (one record a
    rank a call), and dumps that the JAX checker passes."""
    nranks, shape, kw = {
        "slot": (NP, None, {}),
        "mesh_hbm": (NP, (NP,), dict(ICI_INTERPRET=1, DEV_TIER_VMEM_MAX=64)),
        "mesh_vmem": (NP, (NP,), dict(ICI_INTERPRET=1)),
        "mesh_xla": (NP, (NP,), dict(ICI_INTERPRET=1, DEV_TIER_VMEM_MAX=64,
                                     DEV_TIER_XLA_MIN=1024)),
        "fold": (NP, (4,), dict(ICI_INTERPRET=1, DEV_TIER_VMEM_MAX=64)),
    }[case]
    app = _allreduces(with_max=case == "slot")
    pd, jd, ph, jh = _both(env, tmp_path, nranks, shape, app, **kw)
    mine, ref = _signature(pd), _signature(jd)
    assert mine == ref, (mine - ref, ref - mine)
    tier = {"slot": "slot", "mesh_hbm": "hbm", "mesh_vmem": "vmem",
            "mesh_xla": "xla", "fold": "hbm"}[case]
    calls = 3 if case == "slot" else 2
    assert ph == jh
    assert ph[f"lat_dev_{tier}"] == nranks * calls
    bs = [k for k in mine.elements() if k[2] == "dev_allreduce"
          and k[3] == "B"]
    assert len(bs) == nranks * calls
    assert all(dict(k[5])["tier"] == tier for k in bs)
    _check_port_dumps(pd)


def test_mesh_surface_events_match_jax(env, tmp_path):
    """bcast, allgather (K7), alltoall (K10) and reduce_scatter_block
    (stock) on the 1-D mesh: the same spans (op included) and tier
    instants as the JAX package's."""
    def app(comm, ops):
        x = (np.arange(N) % 13 + comm.rank).astype(np.float32)
        comm.bcast(x.copy(), root=3)
        comm.allgather(x[:N // NP])
        comm.alltoall(x)
        comm.reduce_scatter_block(x)
    pd, jd, ph, jh = _both(env, tmp_path, NP, (NP,), app, ICI_INTERPRET=1,
                           **{f"{c}_ALGO": "device" for c in (
                               "BCAST", "ALLGATHER", "ALLTOALL",
                               "REDUCE_SCATTER")})
    mine, ref = _signature(pd), _signature(jd)
    assert mine == ref, (mine - ref, ref - mine)
    assert ph == jh
    names = {k[2] for k in mine}
    assert {"dev_bcast", "dev_allgather", "dev_alltoall",
            "dev_reduce_scatter_block", "ici_allgather",
            "ici_alltoall"} <= names
    _check_port_dumps(pd)


@pytest.mark.parametrize("count", [N, 64])
def test_mesh2d_events_match_jax(env, tmp_path, count):
    """(2, 4) mesh allreduce: RS-x, RS-y, AG-y, AG-x at 16 KiB, one full
    allreduce an axis below DEV_TIER_AXES_MIN at 256 bytes. The events
    match the JAX package's but the per-phase ``ici_<coll>`` instants,
    which the port records as the JAX hardware branch does: each right
    after its ``ici_axis_*`` instant, on the HBM ring tier."""
    def app(comm, ops):
        x = (np.arange(count) % 13 + comm.rank).astype(np.float32)
        comm.allreduce(x)
        comm.allreduce(x * 2)
    pd, jd, ph, jh = _both(env, tmp_path, NP, (2, 4), app,
                           ICI_INTERPRET=1, DEV_TIER_VMEM_MAX=64)
    mine, ref = _signature(pd), _signature(jd)
    phase_names = ("ici_reduce_scatter", "ici_allgather", "ici_allreduce")
    assert collections.Counter({k: v for k, v in mine.items()
                                if k[2] not in phase_names}) == ref
    assert ph == jh and ph["lat_dev_hbm"] == NP * 2
    coll = {"rs": "reduce_scatter", "ag": "allgather", "ar": "allreduce"}
    want = []
    for s in _dumps(jd):
        for _, layer, name, ph_, args in s["events"]:
            if name.startswith("ici_axis_"):
                kind = name[len("ici_axis_"):]
                want.append(_key(s["rank"], layer, name, ph_, args))
                want.append(_key(s["rank"], layer, f"ici_{coll[kind]}", "i",
                                 dict(tier="hbm", bytes=args["bytes"],
                                      op=None if kind == "ag"
                                      else args["op"])))
    got = [_key(s["rank"], *ev[1:]) for s in _dumps(pd) for ev in s["events"]
           if ev[2].startswith("ici_")]
    assert got == want and len(want) == (8 if count == N else 4)
    _check_port_dumps(pd)


def _rma_epochs(win):
    """A fence epoch (put, get, accumulate), a lock epoch on rank 4 (put,
    flush, put, unlock: two waves) and a flush of every rank covering a
    strided put (the epoch tier: no op instant)."""
    win.put(np.full(8, 1.0, np.float32), 0, 7, 2)
    h = win.get(8, 3, 7, 2)
    win.accumulate(np.full(8, 2.0, np.float32), 1, 5, 0)
    win.fence()
    win.lock(4)
    win.put(np.full(8, 3.0, np.float32), 2, 4, 8)
    win.flush(4)
    win.put(np.full(4, 5.0, np.float32), 6, 4, 20)
    win.unlock(4)
    win.put(np.full(4, 7.0, np.float32), 1, 2, 0, stride=3)
    win.flush_local()
    return np.asarray(h.value()), [np.asarray(win.local(r))
                                   for r in range(NP)]


def test_devicewin_events_match_jax(env, tmp_path):
    """DeviceWin in a traced rank thread: the rma_fence / rma_flush spans,
    the lock and unlock instants and each kernel op's instant, in the
    same order with the same arguments as the JAX window's (remote-DMA
    tier in interpret mode), the same lat_rma_flush records, the same
    window contents, and dumps that the rma-epoch automaton passes."""
    got = {}

    def mine(comm):
        win = DeviceWin(MeshComm(make_mesh((NP,), ("x",), "cpu")), 64)
        got["port"] = _rma_epochs(win)

    def ref(comm):
        win = JaxDeviceWin(JaxMeshComm(jax_make_mesh((NP,), ("x",))), 64,
                           interpret=True)
        got["jax"] = _rma_epochs(win)
    pd, jd = tmp_path / "port", tmp_path / "jax"
    ph = _traced(env, pd, lambda: run_ranks(1, mine, device="cpu"), mpit)
    jh = _traced(env, jd, lambda: jax_run_ranks(1, ref), jax_mpit)
    seq = [[ev[1:4] + [{k: v for k, v in (ev[4] or {}).items()}]
            for ev in s["events"] if ev[2].startswith("rma_")]
           for s in (_dumps(pd)[0], _dumps(jd)[0])]
    assert seq[0] == seq[1]
    assert [e[1] for e in seq[0]].count("rma_put") == 3
    assert ph == jh and ph["lat_rma_flush"] == 4
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    for a, b in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_array_equal(a, b)
    _check_port_dumps(pd)


def test_tracing_off_attaches_nothing(env, tmp_path):
    """MV2T_TRACE unset (MV2T_TRACE_DIR set): no recorder, no mpi wrapper,
    no LOWERING recorder and no file; the histograms still record."""
    env(TRACE_DIR=str(tmp_path))
    seen = []

    def app(comm):
        seen.append((comm.u.tracer, hasattr(Comm.allreduce, "__wrapped__"),
                     trace.LOWERING.rec))
        comm.allreduce(torch.ones(N))
    before = mpit.pvar("lat_dev_vmem").count
    run_ranks(NP, app, device_mesh=make_mesh((NP,), ("x",), "cpu"))
    assert seen == [(None, False, None)] * NP
    assert os.listdir(tmp_path) == [] and recorder._active == []
    assert mpit.pvar("lat_dev_vmem").count == before + NP


def test_metrics_off_records_no_histogram(env, monkeypatch):
    """MV2T_METRICS=0: the gate stays down and no histogram moves."""
    monkeypatch.setattr(metrics, "LIVE", None)
    env(METRICS=0)
    before = _counts(mpit)
    run_ranks(NP, _allreduces(), device="cpu")
    assert metrics.LIVE is None and _counts(mpit) == before


def test_histogram_buckets_match_jax():
    """HistPVar's log2 buckets, count and sum are the JAX package's."""
    mine = mpit.HistPVar("t", mpit.PVAR_CLASS_HISTOGRAM)
    ref = jax_mpit.HistPVar("t", jax_mpit.PVAR_CLASS_HISTOGRAM, "t", "")
    for v in (0, -3, 1, 2, 3, 4, 1023, 1024, 1 << 29, 1 << 31, 1 << 40):
        mine.rec(v)
        ref.rec(v)
    assert mine.snapshot() == ref.snapshot()
    assert mine.read() == ref.read() == 11


def test_failed_rank_still_dumps(env, tmp_path):
    """A rank that raises: every rank's ring is still written, and the
    spans it holds are balanced."""
    env(TRACE="1", TRACE_DIR=str(tmp_path))

    def app(comm):
        comm.allreduce(torch.ones(N))
        if comm.rank == 1:
            raise ValueError("rank 1 stops")
        comm.allreduce(torch.ones(N))
    with pytest.raises(RuntimeError, match="failed"):
        run_ranks(NP, app, device="cpu")
    assert len(_dumps(tmp_path)) == NP
    _check_port_dumps(tmp_path)


def test_profile_bracket_writes_a_trace(env, tmp_path):
    """MV2T_JAX_PROFILE=<dir>: binding the ranks starts a torch.profiler
    trace, stopped at exit (here by hand), which leaves a Chrome trace in
    <dir> (the counterpart of the JAX package's jax.profiler bracket)."""
    out = tmp_path / "prof"
    env(JAX_PROFILE=str(out))
    try:
        run_ranks(2, lambda comm: comm.allreduce(torch.ones(N)),
                  device="cpu")
        assert devmod._profiler is not None
    finally:
        path = devmod._stop_profile()
    assert devmod._profiler is None and os.path.dirname(path) == str(out)
    with open(path) as f:
        assert "traceEvents" in json.load(f)
