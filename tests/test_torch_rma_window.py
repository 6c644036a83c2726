"""Parity of the port's device windows (mvapich2_tpu_torch/rma/device.py:
DeviceWin over parallel.mesh.MeshComm, its tier dispatch, the epoch
grammar) with the JAX package's rma/device.py DeviceWin on the 8-device
virtual CPU mesh. There the JAX window takes its epoch tier (the remote-
DMA kernels cannot run off a TPU without the interpreter); the window
semantics are the same on every tier, so the port's window, whose kernel
tier takes the plain versions on the CPU, is held against it.

Data: integer-valued f32, i32 and bf16 payloads (every sum exact), so
every comparison is bitwise. Also: the scenarios of
tests/test_device_rma.py on the port, the port's kernel tier against its
own epoch tier, the get handle before the closing sync, the window carry
round trip, and a CPU dry run of the OSU one-sided bench.

Every test that changes an MV2T_* variable restores it and reloads both
packages' configs in the fixture's teardown."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mvapich2_tpu.ops import pallas_rma
from mvapich2_tpu.parallel import MeshComm as JaxMeshComm
from mvapich2_tpu.parallel import make_mesh as jax_make_mesh
from mvapich2_tpu.parallel.mesh import shard_map
from mvapich2_tpu.rma.device import DeviceWin as JaxDeviceWin
from mvapich2_tpu.utils.config import get_config as jax_config
from mvapich2_tpu_torch import carry, make_mesh, mpit
from mvapich2_tpu_torch.bench import osu_rma
from mvapich2_tpu_torch.ops import rma
from mvapich2_tpu_torch.parallel import MeshComm
from mvapich2_tpu_torch.rma import DeviceWin
from mvapich2_tpu_torch.utils.config import get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NP = 8
DTYPES = {"f32": (jnp.float32, torch.float32),
          "i32": (jnp.int32, torch.int32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jcomm():
    return JaxMeshComm(jax_make_mesh((NP,), ("x",)))


@pytest.fixture(scope="module")
def comm():
    return MeshComm(make_mesh((NP,), ("x",), "cpu"))


@pytest.fixture
def env(monkeypatch):
    """``env(NAME=value or None)`` sets MV2T_NAME for both packages; the
    teardown restores the environment and reloads both configs."""
    def set_env(**kw):
        for k, v in kw.items():
            if v is None:
                monkeypatch.delenv(f"MV2T_{k}", raising=False)
            else:
                monkeypatch.setenv(f"MV2T_{k}", str(v))
        jax_config().reload()
        get_config().reload()
    yield set_env
    monkeypatch.undo()
    jax_config().reload()
    get_config().reload()


def _rows(x):
    """numpy values of a JAX array/numpy array or torch tensor, bf16 as
    f32."""
    if isinstance(x, torch.Tensor):
        return carry.to_numpy(x)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _pvars(*names):
    return {k: mpit.pvar(k).read() for k in names}


# ---------------------------------------------------------------------------
# seeded op sequences against the JAX window
# ---------------------------------------------------------------------------

def _ops(rng, n_win, count):
    """``count`` random ops (kind, origin, target, disp, n, stride, src):
    contiguous and strided, small integer payloads."""
    ops = []
    for _ in range(count):
        kind = ("put", "get", "acc")[rng.integers(3)]
        stride = int(rng.choice([1, 1, 1, 2, 3]))
        n = int(rng.integers(1, 5))
        disp = int(rng.integers(0, n_win - stride * (n - 1)))
        src = rng.integers(-50, 50, size=n).astype(np.float32)
        ops.append((kind, int(rng.integers(NP)), int(rng.integers(NP)),
                    disp, n, stride, src))
    return ops


@pytest.mark.parametrize("dt,seed", [("f32", 0), ("i32", 1), ("bf16", 2)])
def test_random_sequences_match_jax(jcomm, comm, dt, seed):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(seed)
    n_win = 12
    jwin = JaxDeviceWin(jcomm, n_win, dtype=jdt)
    twin = DeviceWin(comm, n_win, tdt)
    init = rng.integers(-100, 100, size=(NP, n_win)).astype(np.float32)
    for r in range(NP):
        jwin.store(r, 0, init[r])
        twin.store(r, 0, init[r])
    for epoch in range(3):
        handles = []
        for kind, o, t, disp, n, stride, src in _ops(rng, n_win, 7):
            for w in (jwin, twin):
                if kind == "get":
                    h = w.get(n, o, t, disp, stride)
                    handles.append(h)
                elif kind == "put":
                    w.put(src, o, t, disp, stride)
                else:
                    w.accumulate(src, o, t, disp, stride)
        jwin.fence()
        twin.fence()
        np.testing.assert_array_equal(_rows(twin.win), _rows(jwin.win),
                                      err_msg=f"epoch {epoch}")
        for a, b in zip(handles[0::2], handles[1::2]):
            np.testing.assert_array_equal(_rows(b.value()), _rows(a.value()))
        for r in range(NP):
            np.testing.assert_array_equal(_rows(twin.local(r)),
                                          _rows(jwin.local(r)))


# ---------------------------------------------------------------------------
# the scenarios of tests/test_device_rma.py, on the port
# ---------------------------------------------------------------------------

def test_put_fence(jcomm, comm):
    wins = (JaxDeviceWin(jcomm, 16), DeviceWin(comm, 16))
    for w in wins:
        for o in range(8):
            w.put(np.full(4, 10.0 + o), origin=o, target=(o + 1) % 8,
                  disp=2)
        w.fence()
    for t in range(8):
        row = _rows(wins[1].local(t))
        np.testing.assert_array_equal(row, _rows(wins[0].local(t)))
        np.testing.assert_array_equal(row[2:6], np.full(4, 10.0 + (t - 1)
                                                        % 8))
        assert not row[:2].any() and not row[6:].any()


def test_get_fence(comm):
    win = DeviceWin(comm, 8)
    for r in range(8):
        win.store(r, 0, np.arange(8, dtype=np.float32) + 100 * r)
    h = win.get(3, origin=2, target=5, disp=4)
    win.fence()
    np.testing.assert_array_equal(_rows(h.value()),
                                  np.arange(4, 7, dtype=np.float32) + 500)


def test_accumulate_and_epoch_reuse(jcomm, comm):
    wins = (JaxDeviceWin(jcomm, 4), DeviceWin(comm, 4))
    for _ in range(2):
        for w in wins:
            for o in range(8):
                w.accumulate(np.full(4, float(o + 1)), origin=o, target=0)
            w.fence()
        np.testing.assert_array_equal(_rows(wins[1].win),
                                      _rows(wins[0].win))
    np.testing.assert_array_equal(_rows(wins[1].local(0)), np.full(4, 72.0))


def test_mixed_epoch_put_then_get(comm):
    win = DeviceWin(comm, 8)
    win.put(np.array([7.0, 8.0]), origin=3, target=6, disp=1)
    h = win.get(2, origin=0, target=6, disp=1)   # sees the put (ordered)
    win.fence()
    np.testing.assert_array_equal(_rows(h.value()), [7.0, 8.0])


def test_kernel_tier_dispatch_and_pvars(comm):
    """A contiguous put takes the kernel tier (K12; on the CPU its plain
    version), counted in dev_rma_tier_rdma and dev_rma_wire_bytes, and
    lands only on the target's row."""
    before = _pvars("dev_rma_tier_rdma", "dev_rma_wire_bytes",
                    "dev_rma_tier_epoch")
    rma.reset_counts()
    win = DeviceWin(comm, 16)
    win.put(np.arange(4, dtype=np.float32) + 1.0, origin=2, target=5,
            disp=3)
    win.fence()
    np.testing.assert_array_equal(_rows(win.local(5))[3:7],
                                  [1.0, 2.0, 3.0, 4.0])
    for r in range(8):
        if r != 5:
            assert not _rows(win.local(r)).any()
    after = _pvars(*before)
    assert after["dev_rma_tier_rdma"] - before["dev_rma_tier_rdma"] == 1
    assert after["dev_rma_wire_bytes"] - before["dev_rma_wire_bytes"] == 16
    assert after["dev_rma_tier_epoch"] == before["dev_rma_tier_epoch"]
    assert rma.PLAIN_CALLS["rma_put"] == 1
    assert win._op_tier(("put", 2, 5, 3, 4, 1)) == ("rdma", None)


def test_lock_flush_unlock(jcomm, comm):
    """Passive-target grammar: lock opens the epoch, flush completes the
    locked rank's queued ops (the get handle resolves), unlock closes
    with a final flush; grammar violations raise."""
    wins = (JaxDeviceWin(jcomm, 16), DeviceWin(comm, 16))
    before = mpit.pvar("dev_rma_flush").read()
    handles = []
    for w in wins:
        w.store(6, 0, np.arange(16, dtype=np.float32))
        w.lock(6)
        h = w.get(5, origin=1, target=6, disp=2)
        w.flush(6)
        handles.append(h.value())
        w.accumulate(np.full(3, 2.5, np.float32), origin=0, target=6,
                     disp=1)
        w.unlock(6)
    np.testing.assert_array_equal(_rows(handles[1]), np.arange(2, 7))
    np.testing.assert_array_equal(_rows(handles[1]), _rows(handles[0]))
    np.testing.assert_array_equal(_rows(wins[1].local(6))[1:4],
                                  np.arange(1, 4) + 2.5)
    np.testing.assert_array_equal(_rows(wins[1].win), _rows(wins[0].win))
    assert mpit.pvar("dev_rma_flush").read() - before == 2
    win = wins[1]
    win.lock(3)
    with pytest.raises(RuntimeError, match="already locked"):
        win.lock(3)
    win.unlock(3)
    with pytest.raises(RuntimeError, match="not locked"):
        win.unlock(3)
    # a flush with nothing queued for the rank is no completion wave
    win.flush(3)
    win.flush_local(3)
    assert mpit.pvar("dev_rma_flush").read() - before == 2


def test_flush_is_per_target(comm):
    """flush(rank) completes only that target's queued ops; the rest stay
    queued until the epoch closes."""
    win = DeviceWin(comm, 8)
    win.put(np.full(2, 3.0, np.float32), origin=0, target=3, disp=0)
    h = win.get(2, origin=1, target=6, disp=0)
    win.put(np.full(2, 4.0, np.float32), origin=0, target=6, disp=0)
    win.flush_local(3)
    np.testing.assert_array_equal(_rows(win.local(3))[:2], 3.0)
    assert not _rows(win.local(6)).any()                 # still queued
    assert len(win._queue) == 2
    with pytest.raises(RuntimeError, match="not yet completed"):
        h.value()
    win.fence()
    np.testing.assert_array_equal(_rows(win.local(6))[:2], 4.0)
    assert not _rows(h.value()).any()          # queue order: get first


def test_strided_put_epoch_fallback(jcomm, comm):
    """A strided op takes the epoch tier, counted in
    dev_rma_fallback_noncontig, with scatter semantics; its get reads
    with the same index."""
    before = _pvars("dev_rma_fallback_noncontig", "dev_rma_tier_epoch")
    rma.reset_counts()
    wins = (JaxDeviceWin(jcomm, 16, dtype=jnp.int32),
            DeviceWin(comm, 16, torch.int32))
    handles = []
    for w in wins:
        w.put(np.arange(4, dtype=np.int32) + 7, origin=0, target=2, disp=1,
              stride=3)
        w.accumulate(np.full(3, 5, np.int32), origin=1, target=2, disp=4,
                     stride=2)
        handles.append(w.get(4, origin=3, target=2, disp=1, stride=3))
        w.fence()
    row = _rows(wins[1].local(2))
    assert list(row[[1, 4, 7, 10]]) == [7, 13, 9, 10], row
    np.testing.assert_array_equal(row, _rows(wins[0].local(2)))
    np.testing.assert_array_equal(_rows(handles[1].value()),
                                  _rows(handles[0].value()))
    assert _rows(handles[1].value()).tolist() == [7, 13, 9, 10]
    after = _pvars(*before)
    assert after["dev_rma_fallback_noncontig"] - \
        before["dev_rma_fallback_noncontig"] == 3
    assert after["dev_rma_tier_epoch"] - before["dev_rma_tier_epoch"] == 3
    assert not any(rma.PLAIN_CALLS.values())


def test_kernel_tier_agrees_with_epoch_tier(comm, env):
    """int32 through the kernel tier equals, bit for bit, the epoch tier
    of the same op sequence (MV2T_DEV_RMA_RDMA_MIN=-1 sends every op
    there, as reason size)."""
    rng = np.random.default_rng(7)
    ops = _ops(rng, 12, 40)
    wins = []
    for rmin in (None, "-1"):
        env(DEV_RMA_RDMA_MIN=rmin)
        before = _pvars("dev_rma_fallback_size", "dev_rma_tier_rdma")
        w = DeviceWin(comm, 12, torch.int32)
        gets = []
        for kind, o, t, disp, n, stride, src in ops:
            src = src.astype(np.int32) * 1000003
            if kind == "get":
                gets.append(w.get(n, o, t, disp, stride))
            elif kind == "put":
                w.put(src, o, t, disp, stride)
            else:
                w.accumulate(src, o, t, disp, stride)
        w.fence()
        wins.append((w, gets, _pvars(*before), before))
        if rmin == "-1":
            assert w._op_tier(("put", 3, 7, 2, 5, 1)) == ("epoch", "size")
    (a, ga, _, _), (b, gb, after, before) = wins
    assert torch.equal(a.win, b.win)
    for x, y in zip(ga, gb):
        assert torch.equal(x.value(), y.value())
    contiguous = sum(1 for op in ops if op[5] == 1)
    assert after["dev_rma_fallback_size"] - \
        before["dev_rma_fallback_size"] == contiguous
    assert after["dev_rma_tier_rdma"] == before["dev_rma_tier_rdma"]


def test_epoch_tier_reasons(comm, env):
    before = _pvars("dev_rma_fallback_dtype", "dev_rma_fallback_size")
    for dt in (torch.bool, torch.complex64):
        w = DeviceWin(comm, 4, dt)
        w.put(np.ones(2), 0, 1, 1)
        h = w.get(2, 2, 1, 1)
        w.fence()
        assert _rows(h.value()).tolist() == [1, 1]
    w = DeviceWin(comm, 4)
    w.put(np.ones(0), 0, 1, 4)          # empty: epoch tier, reason size
    w.fence()
    after = _pvars(*before)
    assert after["dev_rma_fallback_dtype"] - \
        before["dev_rma_fallback_dtype"] == 4
    assert after["dev_rma_fallback_size"] - \
        before["dev_rma_fallback_size"] == 1
    # the quantized accumulate runs (K14's quantized wire, its plain
    # version here), counted on dev_rma_tier_quant with its wire bytes
    env(QUANT_COLL="q8:1e-1", DEV_RMA_QUANT_MIN="64")
    before = _pvars("dev_rma_tier_quant", "dev_rma_wire_bytes")
    w = DeviceWin(comm, 1024)
    w.put(np.ones(4), 0, 1)
    w.accumulate(np.ones(512), 0, 1)
    w.fence()
    want = torch.zeros((NP, 1024))
    want[1, :4] = 1
    rma.rma_accumulate_ref(torch.ones(512), want, 0, 1, quantized=True)
    assert torch.equal(w.win, want) and not w._queue
    after = _pvars(*before)
    assert after["dev_rma_tier_quant"] - before["dev_rma_tier_quant"] == 1
    assert after["dev_rma_wire_bytes"] - before["dev_rma_wire_bytes"] == \
        4 * 4 + 4 * rma.wire_words(512, 128)


@pytest.mark.parametrize("np_dtype", [np.uint16, np.uint32])
def test_unsigned_windows_match_jax(jcomm, comm, np_dtype):
    """uint16 and uint32 windows: puts, accumulates that wrap (contiguous
    on the kernel tier, strided on the epoch tier) and gets, bitwise the
    JAX window."""
    info = np.iinfo(np_dtype)
    rng = np.random.default_rng(info.bits)
    n_win = 12
    jwin = JaxDeviceWin(jcomm, n_win, dtype=jnp.dtype(np_dtype))
    twin = DeviceWin(comm, n_win, getattr(torch, np.dtype(np_dtype).name))
    init = rng.integers(info.max // 2, info.max, size=(NP, n_win),
                        endpoint=True).astype(np_dtype)
    for r in range(NP):
        jwin.store(r, 0, init[r])
        twin.store(r, 0, init[r])
    vals = rng.integers(info.max // 2, info.max, size=(4, 4),
                        endpoint=True).astype(np_dtype)
    handles = []
    for w in (jwin, twin):
        w.accumulate(vals[0], 1, 3, 2)
        w.accumulate(vals[1][:3], 2, 3, 1, stride=3)
        w.put(vals[2], 0, 5, 6)
        handles.append(w.get(4, 4, 3, 0, stride=2))
        w.fence()
    np.testing.assert_array_equal(_rows(twin.win), _rows(jwin.win))
    np.testing.assert_array_equal(_rows(handles[1].value()),
                                  _rows(handles[0].value()))
    assert (_rows(twin.win)[3, 2:6] < init[3, 2:6]).any()     # wrapped


def _jax_quant_acc(rows, src, origin, target, disp):
    """The window rows after the JAX quantized accumulate kernel
    (pallas_rma.rma_accumulate(quantized=True), interpret mode)."""
    mesh = jax_make_mesh((NP,), ("x",))
    f = shard_map(lambda w: pallas_rma.rma_accumulate(
        jnp.asarray(src), w[0], "x", NP, origin, target, disp,
        quantized=True, interpret=True, credits=False)[None, :],
        mesh=mesh, in_specs=(P("x"),), out_specs=P("x"), check_vma=False)
    return np.asarray(jax.jit(f)(jax.device_put(
        jnp.asarray(rows), NamedSharding(mesh, P("x")))))


def test_quant_accumulate_through_the_window(comm, env):
    """An accumulate that MV2T_QUANT_COLL and DEV_RMA_QUANT_MIN send to
    K14's quantized wire, inside a passive epoch between an exact put
    and a get, against a replay whose accumulate is the JAX kernel;
    dev_rma_tier_quant and the wire bytes counted. Under a budget below
    one hop's bound the same accumulate takes the exact wire."""
    env(QUANT_COLL="fp8:1e-1", DEV_RMA_QUANT_MIN="256", QUANT_BLOCK="64")
    rng = np.random.default_rng(17)
    n_win = 96
    init = (rng.standard_normal((NP, n_win)) * 3).astype(np.float32)
    src = rng.standard_normal(64).astype(np.float32)
    putv = rng.standard_normal(8).astype(np.float32)
    pv = ("dev_rma_tier_quant", "dev_rma_tier_rdma", "dev_rma_wire_bytes")
    before = _pvars(*pv)
    w = DeviceWin(comm, n_win)
    for r in range(NP):
        w.store(r, 0, init[r])
    w.lock(5)
    w.put(putv, 0, 5, 0)
    w.accumulate(src, 2, 5, 20)
    h = w.get(8, 1, 5, 88)
    w.unlock(5)
    rows = init.copy()
    rows[5, :8] = putv
    want = _jax_quant_acc(rows, src, 2, 5, 20)
    np.testing.assert_array_equal(_rows(w.win).view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(_rows(h.value()), want[5, 88:96])
    after = _pvars(*pv)
    assert {k: after[k] - before[k] for k in pv} == {
        "dev_rma_tier_quant": 1, "dev_rma_tier_rdma": 2,
        "dev_rma_wire_bytes": 8 * 4 + 8 * 4 + rma.wire_words(64, 16) * 4}
    env(QUANT_COLL="fp8:1e-2")                  # below 1/28: exact wire
    w.accumulate(src, 2, 5, 20)
    w.fence()
    exact = want.copy()
    exact[5, 20:84] = (torch.from_numpy(want[5, 20:84]) +
                       torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(_rows(w.win), exact)
    assert _pvars(*pv)["dev_rma_tier_quant"] == after["dev_rma_tier_quant"]


def test_window_argument_checks(comm):
    with pytest.raises(NotImplementedError, match="8-byte"):
        DeviceWin(comm, 4, torch.float64)
    w = DeviceWin(comm, 8)
    with pytest.raises(ValueError, match="past the window"):
        w.put(np.ones(4), 0, 1, disp=5)
    with pytest.raises(ValueError, match="past the window"):
        w.get(3, 0, 1, disp=3, stride=3)
    with pytest.raises(ValueError, match="rank"):
        w.accumulate(np.ones(2), 0, 8)
    with pytest.raises(ValueError, match="past the window"):
        w.store(1, 7, np.ones(2))
    assert not w._queue


def test_get_handle_before_closing_sync(comm):
    win = DeviceWin(comm, 8)
    h = win.get(2, 0, 1)
    with pytest.raises(RuntimeError, match="not yet completed"):
        h.value()
    win.fence()
    assert h.value().shape == (2,)


# ---------------------------------------------------------------------------
# the window carry, and the OSU one-sided bench
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ("f32", "i32", "bf16"))
def test_window_from_numpy_round_trip(jcomm, comm, dt):
    jdt, tdt = DTYPES[dt]
    jwin = JaxDeviceWin(jcomm, 6, dtype=jdt)
    for r in range(NP):
        jwin.store(r, 0, np.arange(6, dtype=np.float32) * (r + 1) - 3)
    rows = np.asarray(jwin.win)
    t = carry.window_from_numpy(rows)
    assert t.dtype == tdt and t.shape == (NP, 6)
    np.testing.assert_array_equal(carry.to_numpy(t), _rows(rows))
    # carried into a port window, the same ops give the same rows
    twin = DeviceWin(comm, 6, tdt)
    twin.win = t
    for w in (jwin, twin):
        w.accumulate(np.full(3, 2.0, np.float32), 4, 5, 2)
        w.fence()
    np.testing.assert_array_equal(_rows(twin.win), _rows(jwin.win))
    with pytest.raises(ValueError):
        carry.window_from_numpy(rows[0])


def test_osu_rma_sweep_and_replay():
    keep = []
    art = osu_rma.sweep([64, 256], n=512, device="cpu", warmup=1, iters=2,
                        window=4, keep=keep)
    win = keep[-1]["win"]
    band = keep[:-1]
    assert [e["kind"] for e in band] == (["put"] * 2 + ["get"] * 2
                                         + ["acc"] * 2 + ["put", "get",
                                                          "acc",
                                                          "direct_put"])
    want, gets = osu_rma.replay(band, NP, 512, "cpu")
    assert torch.equal(win.win, want)
    kept = [e["value"] for e in band if e["kind"] == "get"]
    assert len(kept) == len(gets) == 3
    for a, b in zip(kept, gets):
        assert torch.equal(a, b)
    for band_name in ("dev_put_bw", "dev_get_bw", "dev_acc_bw"):
        assert set(art["results"][band_name]) == {"64", "256"}
    assert art["rma_tiers"] == {"64": "rdma", "256": "rdma"}
    assert art["detail"]["platform"] == "cpu"
    with pytest.raises(ValueError, match="does not fit"):
        osu_rma.sweep([4096], n=512, device="cpu")


def test_osu_rma_needs_a_card_unless_asked(monkeypatch, comm):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        osu_rma.sweep([64], n=64, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        osu_rma.breakdown(DeviceWin(comm, 64), "put", 64)


def test_osu_rma_cli_dry_run():
    out = subprocess.run(
        [sys.executable, "-m", "mvapich2_tpu_torch.bench.osu_rma",
         "--device", "cpu", "--sizes", "64,1024", "--n", "1024",
         "--warmup", "1", "--iters", "1", "--window", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    art = json.loads(out.stdout)
    for band in ("dev_put_bw", "dev_get_bw", "dev_acc_bw"):
        assert all(v > 0 for v in art["results"][band].values())
        assert set(art["results"][band]) == {"64", "1024"}
    assert set(art["latency_us"]) == {"put", "get", "acc"}
    assert set(art["whole"]) == {"put", "get", "acc", "direct_put"}
    assert art["detail"]["device"] == "cpu"


# ---------------------------------------------------------------------------
# a payload that is a view of the window, on both tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rmin", (None, "-1"), ids=("rdma", "epoch"))
@pytest.mark.parametrize("lo,stride", [(3, 1), (9, 1), (6, 1), (5, 2)],
                         ids=("before", "after", "alias", "strided"))
def test_put_from_a_view_of_the_window_matches_jax(jcomm, comm, env, rmin,
                                                   lo, stride):
    """DeviceWin.put with ``win.win[t, a:b]`` as the payload writes the
    values the payload held before the put (the JAX window gets a numpy
    copy), on the kernel tier and on the epoch tier."""
    env(DEV_RMA_RDMA_MIN=rmin)
    n, disp, target = 6, 6, 5
    init = np.random.default_rng(lo + stride).integers(
        -100, 100, size=(NP, 20)).astype(np.float32)
    jwin, twin = JaxDeviceWin(jcomm, 20), DeviceWin(comm, 20)
    for r in range(NP):
        jwin.store(r, 0, init[r])
        twin.store(r, 0, init[r])
    before = _pvars("dev_rma_tier_rdma", "dev_rma_tier_epoch")
    jwin.put(init[target, lo:lo + n].copy(), 2, target, disp, stride)
    twin.put(twin.win[target, lo:lo + n], 2, target, disp, stride)
    jwin.fence()
    twin.fence()
    np.testing.assert_array_equal(_rows(twin.win), _rows(jwin.win))
    tier = "dev_rma_tier_rdma" if rmin is None and stride == 1 else \
        "dev_rma_tier_epoch"
    assert _pvars(tier)[tier] - before[tier] == 1


def test_store_from_a_view_of_the_window(jcomm, comm):
    init = np.arange(NP * 12, dtype=np.float32).reshape(NP, 12)
    jwin, twin = JaxDeviceWin(jcomm, 12), DeviceWin(comm, 12)
    for r in range(NP):
        jwin.store(r, 0, init[r])
        twin.store(r, 0, init[r])
    jwin.store(4, 3, init[4, 1:7].copy())
    twin.store(4, 3, twin.win[4, 1:7])
    np.testing.assert_array_equal(_rows(twin.win), _rows(jwin.win))


@pytest.mark.parametrize("rmin", (None, "-1"), ids=("rdma", "epoch"))
@pytest.mark.parametrize("lo", (6, 8), ids=("alias", "after"))
def test_accumulate_from_a_view_of_the_window_matches_jax(jcomm, comm, env,
                                                          rmin, lo):
    """DeviceWin.accumulate with ``win.win[t, a:b]`` as the payload folds
    the values the payload held before the op: from the target range
    itself (K14's exact alias, which doubles the range) and from a range
    that overlaps it, on the kernel tier and on the epoch tier."""
    env(DEV_RMA_RDMA_MIN=rmin)
    n, disp, target = 6, 6, 3
    init = np.random.default_rng(lo).integers(
        -100, 100, size=(NP, 20)).astype(np.float32)
    jwin, twin = JaxDeviceWin(jcomm, 20), DeviceWin(comm, 20)
    for r in range(NP):
        jwin.store(r, 0, init[r])
        twin.store(r, 0, init[r])
    jwin.accumulate(init[target, lo:lo + n].copy(), 1, target, disp)
    twin.accumulate(twin.win[target, lo:lo + n], 1, target, disp)
    jwin.fence()
    twin.fence()
    np.testing.assert_array_equal(_rows(twin.win), _rows(jwin.win))
    if lo == disp:
        np.testing.assert_array_equal(_rows(twin.win)[target, 6:12],
                                      2 * init[target, 6:12])


def test_dispatch_looks_up_no_stream_for_a_cpu_window(comm, monkeypatch):
    """A wave on a CPU window hands every kernel-tier op ``stream=None``
    and asks torch for no CUDA stream or device context (on the card the
    wave looks both up once)."""
    seen = []
    for name in ("rma_put", "rma_get", "rma_accumulate"):
        real = getattr(rma, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw["stream"])
            return _real(*a, **kw)
        monkeypatch.setattr(rma, name, spy)

    def no_cuda(*a, **kw):
        raise AssertionError("a CUDA lookup on a CPU window")
    monkeypatch.setattr(torch.cuda, "current_stream", no_cuda)
    monkeypatch.setattr(torch.cuda, "device", no_cuda)
    win = DeviceWin(comm, 16)
    win.put(np.ones(4), 0, 7, 2)
    win.accumulate(np.ones(4), 1, 7, 2)
    h = win.get(4, 3, 7, 2)
    win.fence()
    assert seen == [None, None, None]
    np.testing.assert_array_equal(_rows(h.value()), np.full(4, 2.0))


# ---------------------------------------------------------------------------
# a window over one axis of a multi-axis mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ("f32", "i32"))
@pytest.mark.parametrize("axis", ("x", "y"))
def test_window_on_one_axis_of_a_2x4_mesh_matches_jax(axis, dt):
    """A DeviceWin over one axis of the (2, 4) mesh has ``p`` rows, the
    axis's extent, as the JAX DeviceWin over the same axis of the
    8-device CPU mesh (its rows sharded over the axis, copied over the
    other). Contiguous puts, gets and accumulates of integer values take
    K12, K13 and K14 (their plain versions here), strided ones the epoch
    tier; every row and every get bitwise the JAX window's. K17
    (``direct_put``) into the window tensor then writes the same row
    range as a JAX put."""
    jdt, tdt = DTYPES[dt]
    shape, axes = (2, 4), ("x", "y")
    jcomm_ax = JaxMeshComm(jax_make_mesh(shape, axes), axis)
    comm_ax = MeshComm(make_mesh(shape, axes, "cpu"), axis)
    p = dict(zip(axes, shape))[axis]
    n_win = 16
    jwin = JaxDeviceWin(jcomm_ax, n_win, dtype=jdt)
    twin = DeviceWin(comm_ax, n_win, tdt)
    assert jwin.p == twin.p == p and twin.win.shape == (p, n_win)
    rng = np.random.default_rng(900 + p)
    init = rng.integers(-100, 100, size=(p, n_win)).astype(np.float32)
    for r in range(p):
        jwin.store(r, 0, init[r])
        twin.store(r, 0, init[r])
    jh, th = [], []
    for k in range(3 * p):
        o, t = k % p, (k * 3 + 1) % p
        src = rng.integers(-50, 50, size=4).astype(np.float32)
        stride = 2 if k % 5 == 4 else 1
        for w in (jwin, twin):
            if k % 3 == 0:
                w.put(src, o, t, disp=k % 5, stride=stride)
            elif k % 3 == 1:
                w.accumulate(src, o, t, disp=k % 7, stride=stride)
            else:
                (jh if w is jwin else th).append(w.get(
                    4, o, t, disp=k % 6, stride=stride))
    rma.reset_counts()
    jwin.fence()
    twin.fence()
    assert all(rma.PLAIN_CALLS[k] > 0
               for k in ("rma_put", "rma_get", "rma_accumulate"))
    np.testing.assert_array_equal(_rows(twin.win), _rows(jwin.win))
    for a, b in zip(th, jh):
        np.testing.assert_array_equal(_rows(a.value()), _rows(b.value()))
    src = np.arange(5, dtype=np.float32) + 40
    jwin.put(src, 0, p - 1, disp=3)
    jwin.fence()
    rma.direct_put(torch.from_numpy(src).to(tdt), twin.win, 0, p - 1,
                   disp=3)
    assert rma.PLAIN_CALLS["direct_put"] == 1
    np.testing.assert_array_equal(_rows(twin.win), _rows(jwin.win))


def test_window_over_several_axes_raises_as_jax_fails():
    """A comm that spans both axes of the (2, 4) mesh: the JAX DeviceWin
    builds 8 rows sharded over the first axis only and raises IndexError
    at its first closing call; the port's refuses at construction with
    NotImplementedError naming the axes."""
    jwin = JaxDeviceWin(JaxMeshComm(jax_make_mesh((2, 4), ("x", "y")),
                                    ("x", "y")), 8)
    jwin.put(np.ones(2, np.float32), 0, 7, 0)
    with pytest.raises(IndexError):
        jwin.fence()
    with pytest.raises(NotImplementedError, match=r"spans the axes"):
        DeviceWin(MeshComm(make_mesh((2, 4), ("x", "y"), "cpu"),
                           ("x", "y")), 8)
