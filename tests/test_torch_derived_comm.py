"""Device channels of the comms made by dup, create, split and
split_type_shared (``coll/device.py`` ``bind_derived``), and the
nonblocking device tier of the slot and fold channels, held against the
JAX package on the CPU.

* A tensor call on a derived comm runs the channel its members' geometry
  gives (here the kernels' plain versions, with ``to_host`` made to
  fail): on the slot channel, the 1:1 mesh of 8, 8 ranks over a 4-device
  fold mesh and the (2, 4) mesh, for dup, create, split (in reversed key
  order), split_type_shared over two fake nodes and a split of a split.
  The JAX package stages such a call through its host tier: the results
  are equal bit for bit on integer-valued data.
* A numpy call on a derived comm takes the host tier with the JAX
  package's results and ``pt2pt_*``/``coll_*`` pvar deltas, and no
  ``dev_coll_fallback_nbc``.
* A geometry that binds nothing keeps the refusal, naming it; ``free``
  releases the registry entry; a rank that raises makes a peer blocked
  in a sub-comm's call fail within seconds.
* i-collectives and ``*_init`` twins of tensors on the slot and fold
  channels ride the device NBC tier and equal the blocking calls and the
  JAX package's i-collectives; a failing segment raises out of every
  rank's wait().
"""

import time

import numpy as np
import pytest
import torch

from mvapich2_tpu import run_ranks as jax_run_ranks

from mvapich2_tpu_torch import make_mesh, mpit, run_ranks
from mvapich2_tpu_torch.coll import device as devmod
from mvapich2_tpu_torch.core import comm as comm_mod
from mvapich2_tpu_torch.core.errors import (MPI_ERR_COMM, MPI_ERR_INTERN,
                                            MPIX_ERR_PROC_FAILED,
                                            MPIException)
from mvapich2_tpu_torch.ops import alltoall, hbm, ici, ring

from test_torch_pt2pt import (JAX, PORT, TIMEOUT, assert_same, env,  # noqa: F401
                              run_both)

P = 8
NODES = [0, 0, 0, 0, 1, 1, 1, 1]
MODS = (alltoall, hbm, ici, ring)
GEOMS = {"slot": None, "mesh": ((8,), ("x",)), "fold": ((4,), ("x",)),
         "mesh24": ((2, 4), ("x", "y"))}
DERIVE = ("dup", "create", "split", "split_type_shared", "split_of_split")

# the channel each derived comm binds, by geometry: 1:1 over the run's
# own mesh (multi-axis too) where the members are its devices in order
CHANNEL = {
    "slot": dict.fromkeys(DERIVE, ("HBMSlotChannel", None)),
    "mesh": {"dup": ("DeviceCollChannel", (8,)),
             "create": ("DeviceCollChannel", (4,)),
             "split": ("DeviceCollChannel", (4,)),
             "split_type_shared": ("DeviceCollChannel", (4,)),
             "split_of_split": ("DeviceCollChannel", (2,))},
    "fold": {"dup": ("DeviceFoldChannel", (4,)),
             "create": ("DeviceFoldChannel", (2,)),
             "split": ("DeviceCollChannel", (4,)),
             "split_type_shared": ("DeviceFoldChannel", (2,)),
             "split_of_split": ("DeviceCollChannel", (2,))},
    "mesh24": {"dup": ("DeviceCollChannel", (2, 4)),
               "create": ("DeviceCollChannel", (4,)),
               "split": ("DeviceCollChannel", (4,)),
               "split_type_shared": ("DeviceCollChannel", (4,)),
               "split_of_split": ("DeviceCollChannel", (2,))},
}


def _mesh(geom):
    g = GEOMS[geom]
    return None if g is None else make_mesh(*g, "cpu")


def _ints(rank, n, seed=0):
    rng = np.random.default_rng(seed * 1000 + rank)
    return rng.integers(-50, 50, n).astype(np.float32)


def _derive(kind, c):
    r = c.rank
    if kind == "dup":
        return c.dup()
    if kind == "create":
        return c.create(c.group.incl([0, 1, 2, 3]))
    if kind == "split":
        return c.split(r % 2, key=-r)
    if kind == "split_type_shared":
        return c.split_type_shared()
    return c.split(r // 4).split(r % 2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _collectives(d, tensor):
    """Seeded integer-valued calls on ``d``: tensors or numpy buffers."""
    r, k = d.rank, d.size
    wr = d.group.world_of_rank(r)

    def buf(x):
        return torch.from_numpy(x.copy()) if tensor else x.copy()
    out = {"allreduce": d.allreduce(buf(_ints(wr, 1024))),
           "allgather": d.allgather(buf(_ints(wr, 64, 1))),
           "alltoall": d.alltoall(buf(_ints(wr, 16 * k, 2))),
           "reduce_scatter_block": d.reduce_scatter_block(
               buf(_ints(wr, 8 * k, 3)))}
    b = _ints(wr, 256, 4) if r == k - 1 else np.zeros(256, np.float32)
    got = d.bcast(buf(b), root=k - 1)
    out["bcast"] = got if got is not None else b
    sc = [(r + 2 * j) % 3 + 1 for j in range(k)]
    rc = [(j + 2 * r) % 3 + 1 for j in range(k)]
    send = buf(_ints(wr, sum(sc), 5))
    recv = None if tensor else np.zeros(sum(rc), np.float32)
    got = d.alltoallv(send, sc, np.cumsum([0] + sc[:-1]).tolist(), recv,
                      rc, np.cumsum([0] + rc[:-1]).tolist())
    out["alltoallv"] = got if got is not None else recv
    return {key: _np(v) for key, v in out.items()}


_JAX_REF = {}


def _jax_ref(kind):
    """The JAX package's results (its host tier: a derived comm there has
    no device channel), once a derivation."""
    if kind not in _JAX_REF:
        def app(c):
            d = _derive(kind, c)
            return None if d is None else _collectives(d, False)
        _JAX_REF[kind] = jax_run_ranks(P, app, nodes=NODES, timeout=TIMEOUT)
    return _JAX_REF[kind]


def _no_staging(monkeypatch):
    def refuse(t):
        raise AssertionError("a tensor was staged to the host")
    monkeypatch.setattr(devmod, "to_host", refuse)
    monkeypatch.setattr(comm_mod, "to_host", refuse)


@pytest.mark.parametrize("kind", DERIVE)
@pytest.mark.parametrize("geom", list(GEOMS))
def test_derived_tensor_calls_match_jax(env, monkeypatch, geom, kind):
    """Each derived comm binds the channel its geometry gives and runs a
    tensor's collectives there (the plain kernels, no staging); the
    results equal the JAX package's host results bit for bit."""
    ref = _jax_ref(kind)
    _no_staging(monkeypatch)
    for m in MODS:
        m.reset_counts()

    def app(c):
        d = _derive(kind, c)
        if d is None:
            return None
        ch = d.device_channel
        mesh = getattr(ch, "mesh", None)
        kind_got = (type(ch).__name__,
                    None if mesh is None else tuple(mesh.shape.values()))
        return _collectives(d, True), kind_got, ch.derived
    got = run_ranks(P, app, device_mesh=_mesh(geom), nodes=NODES,
                    device="cpu" if GEOMS[geom] is None else None,
                    timeout=TIMEOUT)
    for r, (mine, want) in enumerate(zip(got, ref)):
        if want is None:
            assert mine is None, r
            continue
        assert mine[1] == CHANNEL[geom][kind] and mine[2], (r, mine[1])
        assert_same(want, mine[0])
    plain = {k: v for m in MODS for k, v in m.PLAIN_CALLS.items() if v}
    assert plain, "no kernel's plain version ran"


@pytest.mark.parametrize("geom", ["slot", "mesh", "fold"])
def test_numpy_on_derived_comm_keeps_the_jax_route(env, geom):
    """numpy on a derived comm: the host tier, with the JAX package's
    bits and pt2pt_*/coll_* pvar deltas; an i-call counts no
    dev_coll_fallback_nbc; a tensor recvbuf under a numpy sendbuf is
    MPI_ERR_COMM, as on a comm with no channel."""
    def app(c, lib):
        d = c.split(c.rank % 2, key=-c.rank)
        out = _collectives(d, False)
        x = _ints(c.rank, 5000, 6)
        out["allreduce_5000"] = d.allreduce(x)
        res = np.zeros_like(x)
        d.iallreduce(x, res).wait()
        out["iallreduce"] = res
        err = None
        if lib is PORT:
            with pytest.raises(MPIException) as ei:
                d.allreduce(x, torch.zeros(5000))
            err = ei.value.error_class
        d.free()
        return out, err

    before = mpit.pvar("dev_coll_fallback_nbc").read()
    j, p = run_both(P, app, device_mesh=_mesh(geom))
    assert_same([o for o, _ in j], [o for o, _ in p])
    assert all(e == MPI_ERR_COMM for _, e in p)
    assert mpit.pvar("dev_coll_fallback_nbc").read() == before


def test_unbound_geometry_still_raises(env):
    """8 ranks over a 4-device fold mesh split into ranks 0-2 (devices 0,
    0, 1) and 3-7 (1, 2, 2, 3, 3): neither binds a channel. A tensor on
    the card is refused naming the geometry; a CPU tensor is staged as
    on any comm with no channel."""
    def app(c):
        d = c.split(int(c.rank >= 3))
        assert d.device_channel is None
        with pytest.raises(NotImplementedError) as ei:
            d.allreduce(torch.ones(64, device="meta"))
        got = d.allreduce(torch.ones(64))
        return str(ei.value), type(got).__name__, float(got[0])

    got = run_ranks(P, app, device_mesh=_mesh("fold"), timeout=TIMEOUT)
    for r, (msg, typ, val) in enumerate(got):
        devs = "[0, 0, 1]" if r < 3 else "[1, 2, 2, 3, 3]"
        assert f"virtual devices {devs}" in msg and \
            "not moved to the host" in msg, msg
        assert typ == "ndarray" and val == (3 if r < 3 else 5)


def test_free_releases_the_registry_entry(env):
    """Every member holds a reference to its comm's rendezvous in the
    root's registry; the last free removes the entry."""
    seen = {}

    def app(c):
        root = c.device_channel.rv
        s = c.split(c.rank % 2)
        d = s.dup()
        c.barrier()
        if c.rank == 0:
            seen["live"] = sorted(ent[1] for ent in root.children.values())
        c.barrier()
        d.free()
        s.free()
        s.free()                # a second free is a no-op
        c.barrier()
        return len(root.children)

    assert run_ranks(P, app, device="cpu", timeout=TIMEOUT) == [0] * P
    assert seen["live"] == [4, 4, 4, 4]


@pytest.mark.parametrize("blocking", [True, False],
                         ids=["blocking", "nonblocking"])
def test_dead_rank_fails_sub_comm_peers(env, blocking):
    """Rank 3 raises while rank 1, its partner in a split, waits for it in
    an allreduce (the rendezvous barrier) or in an iallreduce's wait():
    rank 1 fails within seconds, far inside run_ranks' timeout."""
    outcome = {}

    def app(c):
        s = c.split(c.rank % 2)
        x = torch.ones(64)
        if c.rank == 3:
            time.sleep(0.3)
            raise ValueError("the victim dies")
        t0 = time.perf_counter()
        try:
            if blocking:
                s.allreduce(x)
            else:
                s.iallreduce(x, torch.zeros(64)).wait()
            outcome[c.rank] = "completed"
        except (RuntimeError, MPIException) as e:
            outcome[c.rank] = (getattr(e, "error_class", None),
                               time.perf_counter() - t0)
            raise

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="failed"):
        run_ranks(4, app, device="cpu", timeout=60)
    assert time.perf_counter() - t0 < 10
    assert outcome[0] == outcome[2] == "completed"
    assert outcome[1][1] < 5, outcome
    if not blocking:
        assert outcome[1][0] == MPIX_ERR_PROC_FAILED


def _icalls(c, lib, tensor):
    """The five i-collectives and allreduce_init (3 starts) of seeded
    integer-valued buffers; returns (results, whether every request rode
    the device tier)."""
    r, k = c.rank, c.size

    def buf(x):
        return torch.from_numpy(x.copy()) if tensor else x.copy()

    def empty(n):
        return torch.zeros(n) if tensor else np.zeros(n, np.float32)
    out, dev = {}, []

    def run(name, req, res):
        req.wait()
        dev.append(getattr(req, "device_nbc", False))
        out[name] = _np(res)
    x = buf(_ints(r, 1024))
    res = empty(1024)
    run("iallreduce", c.iallreduce(x, res), res)
    b = buf(_ints(r, 256, 4) if r == 1 else np.zeros(256, np.float32))
    run("ibcast", c.ibcast(b, root=1), b)
    res = empty(64 * k)
    run("iallgather", c.iallgather(buf(_ints(r, 64, 1)), res), res)
    res = empty(16 * k)
    run("ialltoall", c.ialltoall(buf(_ints(r, 16 * k, 2)), res), res)
    sc = [(r + 2 * j) % 3 + 1 for j in range(k)]
    rc = [(j + 2 * r) % 3 + 1 for j in range(k)]
    res = empty(sum(rc))
    run("ialltoallv", c.ialltoallv(
        buf(_ints(r, sum(sc), 5)), sc, np.cumsum([0] + sc[:-1]).tolist(),
        res, rc, np.cumsum([0] + rc[:-1]).tolist()), res)
    res = empty(1024)
    req = c.allreduce_init(buf(_ints(r, 1024, 7)), res)
    starts = []
    for _ in range(3):
        req.start()
        req.wait()
        starts.append(_np(res).copy())
    req.free()
    out["allreduce_init"] = np.concatenate(starts)
    return out, all(dev)


def _blocking_calls(c):
    r, k = c.rank, c.size
    t = lambda x: torch.from_numpy(x.copy())   # noqa: E731
    b = t(_ints(r, 256, 4) if r == 1 else np.zeros(256, np.float32))
    sc = [(r + 2 * j) % 3 + 1 for j in range(k)]
    rc = [(j + 2 * r) % 3 + 1 for j in range(k)]
    ar = c.allreduce(t(_ints(r, 1024, 7))).numpy()
    return {"iallreduce": c.allreduce(t(_ints(r, 1024))).numpy(),
            "ibcast": c.bcast(b, root=1).numpy(),
            "iallgather": c.allgather(t(_ints(r, 64, 1))).numpy(),
            "ialltoall": c.alltoall(t(_ints(r, 16 * k, 2))).numpy(),
            "ialltoallv": c.alltoallv(t(_ints(r, sum(sc), 5)), sc, None,
                                      None, rc, None).numpy(),
            "allreduce_init": np.concatenate([ar] * 3)}


_JAX_NBC = []


@pytest.mark.parametrize("geom", ["slot", "fold", "fold2", "slot_dup"])
def test_slot_and_fold_icalls_ride_the_device_tier(env, geom):
    """On the slot channel, 8 ranks over 4 and 2 fold devices, and a dup
    of the slot channel's comm, tensor i-collectives and allreduce_init
    ride the device NBC tier (dev_nbc_segments moves, no
    dev_coll_fallback_nbc, dev_persistent_starts +3 a rank) and equal the
    blocking calls and the JAX package's host i-collectives."""
    env(DEVICE_NBC_SEG_BYTES="512")     # 1024 f32 -> 8 segments
    if not _JAX_NBC:
        _JAX_NBC.extend(jax_run_ranks(P, lambda c: _icalls(c, JAX, False)[0],
                                      timeout=TIMEOUT))
    mesh = {"fold": make_mesh((4,), ("x",), "cpu"),
            "fold2": make_mesh((2,), ("x",), "cpu")}.get(geom)
    pv = ("dev_nbc_segments", "dev_coll_fallback_nbc",
          "dev_persistent_starts")
    before = {k: mpit.pvar(k).read() for k in pv}

    def app(c):
        d = c.dup() if geom == "slot_dup" else c
        return _icalls(d, PORT, True), _blocking_calls(d)
    got = run_ranks(P, app, device="cpu" if mesh is None else None,
                    device_mesh=mesh, timeout=TIMEOUT)
    moved = {k: mpit.pvar(k).read() - before[k] for k in pv}
    for r, ((nb, rode), blk) in enumerate(got):
        assert rode, r
        assert_same(_JAX_NBC[r], nb)
        assert_same(blk, nb)
    # 8 segments of 512 B for the iallreduce and each of 3 persistent
    # starts, 2 for the 1 KiB ibcast, one each for the other three
    assert moved == {"dev_nbc_segments": 8 + 2 + 3 + 3 * 8,
                     "dev_coll_fallback_nbc": 0,
                     "dev_persistent_starts": 3 * P}


@pytest.mark.parametrize("geom", ["slot", "fold"])
def test_failed_segment_raises_on_every_rank(env, monkeypatch, geom):
    """A K1 that fails to launch raises out of every rank's wait() on the
    slot and fold channels, with the cause kept."""
    def broken(xs):
        raise RuntimeError("the kernel did not launch")
    monkeypatch.setattr(hbm, "hbm_slot_allreduce", broken)

    def app(c):
        req = c.iallreduce(torch.ones(1024), torch.zeros(1024))
        with pytest.raises(MPIException) as ei:
            req.wait()
        return ei.value.error_class, repr(ei.value.__cause__)

    mesh = make_mesh((4,), ("x",), "cpu") if geom == "fold" else None
    got = run_ranks(P, app, device="cpu" if mesh is None else None,
                    device_mesh=mesh, timeout=TIMEOUT)
    for cls, cause in got:
        assert cls == MPI_ERR_INTERN and "did not launch" in cause
    assert mpit.pvar("nbc_scheds_active").read() == 0


def test_land_contention_bench_dry_run(tmp_path):
    """``bench/land_contention.py`` on the CPU: every case under both
    switch intervals, the landing copies checked, the interval put
    back."""
    import json
    import sys
    from mvapich2_tpu_torch.bench import land_contention
    before = sys.getswitchinterval()
    out = tmp_path / "land.json"
    land_contention.main(["--device", "cpu", "--threads", "1", "--iters",
                          "1", "--seg-kib", "16", "--out", str(out)])
    res = json.loads(out.read_text())
    assert sys.getswitchinterval() == before
    assert res["segment_bytes"] == 16 * 1024
    assert len(res["cases"]) == 2
    for cases in res["cases"].values():
        assert set(cases) == set(land_contention.CASES)
        assert cases["alone"]["polls_a_round"] == 0
        assert all(c["ms"] > 0 for c in cases.values())
