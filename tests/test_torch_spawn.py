"""The port's dynamic processes (``runtime/spawn.py``,
``runtime/nameserv.py``, the proc table of ``runtime/universe.py``, the
KVS verbs of ``runtime/kvs.py`` and the ``mpi`` surface) held against
the JAX package on the CPU.

Thread mode: one program runs through the JAX ``run_ranks`` and the
port's ``run_ranks(..., device="cpu")``; the parents spawn rank threads
from a callable, and the parents' and the children's results (seeded
integer values) are equal bit for bit. Covered: spawn and its
intercomm, ``Comm_spawn_multiple``'s appnum, merge after a spawn, ports
through the name service, the name service's error classes, and
analogs of MPICH's ``spaconacc``, ``spaiccreate``, ``taskmaster``,
``multiple_ports`` and ``disconnect_reconnect`` (``conformance/
spawn.json`` names them). Every service name is used once in the whole
suite: both packages keep a process-global registry in thread mode.

Process mode: one job of ``progs/spawn_parent.py`` under the port's
``mpirun`` (a 120 s limit) prints ``No Errors``, first fails a spawn of
a missing program with MPI_ERR_SPAWN, and leaves no child running; the
JAX package's own spawn job beside it is marked slow, as
``tests/test_spawn.py`` marks it.
"""

import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from mvapich2_tpu import mpi as jax_mpi
from mvapich2_tpu import run_ranks as jax_run_ranks
from mvapich2_tpu.core import errors as jax_errors
from mvapich2_tpu.core import intercomm as jax_ic
from mvapich2_tpu.core import status as jax_status
from mvapich2_tpu.runtime import kvs as jax_kvs
from mvapich2_tpu.runtime import nameserv as jax_ns
from mvapich2_tpu.runtime import spawn as jax_sp
from mvapich2_tpu.runtime import universe as jax_uni

from mvapich2_tpu_torch import mpi as port_mpi
from mvapich2_tpu_torch import run_ranks
from mvapich2_tpu_torch.core import errors as port_errors
from mvapich2_tpu_torch.core import intercomm as port_ic
from mvapich2_tpu_torch.core import status as port_status
from mvapich2_tpu_torch.runtime import kvs as port_kvs
from mvapich2_tpu_torch.runtime import nameserv as port_ns
from mvapich2_tpu_torch.runtime import spawn as port_sp
from mvapich2_tpu_torch.runtime import universe as port_uni

from test_torch_pt2pt import TIMEOUT, assert_same, env  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = types.SimpleNamespace(name="jax", sp=jax_sp, ns=jax_ns, uni=jax_uni,
                            ic=jax_ic, mpi=jax_mpi, st=jax_status)
PORT = types.SimpleNamespace(name="port", sp=port_sp, ns=port_ns,
                             uni=port_uni, ic=port_ic, mpi=port_mpi,
                             st=port_status)


def _both(n, app):
    """``app(world, lib, box)`` on ``n`` ranks of each package, ``box`` a
    dict the children write: ((JAX results, box), (port results,
    box))."""
    jbox, pbox = {}, {}
    j = jax_run_ranks(n, lambda c: app(c, JAX, jbox), timeout=TIMEOUT)
    p = run_ranks(n, lambda c: app(c, PORT, pbox), device="cpu",
                  timeout=TIMEOUT)
    return (j, jbox), (p, pbox)


def _vals(seed, rank, n, dtype=np.int64):
    rng = np.random.default_rng(seed * 7919 + rank)
    return rng.integers(-1000, 1000, n).astype(dtype)


def _parent(lib):
    return lib.sp.get_parent(lib.uni.current_universe())


def test_error_classes_are_the_jax_ones():
    for name in ("MPI_ERR_PORT", "MPI_ERR_NAME", "MPI_ERR_SERVICE",
                 "MPI_ERR_SPAWN"):
        assert getattr(port_errors, name) == getattr(jax_errors, name)
    assert port_sp.PORT_CTX == jax_sp.PORT_CTX


@pytest.mark.parametrize("nparents,nchildren", [(2, 2), (3, 1), (1, 3)])
def test_spawn_intercomm(env, nparents, nchildren):
    def app(world, lib, box):
        def child(cw):
            parent = _parent(lib)
            out = parent.allreduce(_vals(1, 100 + cw.rank, 64))
            rb = parent.allgather(_vals(2, 100 + cw.rank, 2), count=2)
            box[cw.rank] = (parent.is_inter, parent.size, parent.rank,
                            parent.remote_size, cw.size, out, rb)
            parent.barrier()

        inter, errs = lib.sp.comm_spawn(world, child, maxprocs=nchildren,
                                        root=0)
        out = inter.allreduce(_vals(1, world.rank, 64))
        rb = inter.allgather(_vals(2, world.rank, 2), count=2)
        inter.barrier()
        return (list(errs), inter.is_inter, inter.size, inter.remote_size,
                list(inter.remote_group.world_ranks), out, rb)

    (j, jbox), (p, pbox) = _both(nparents, app)
    assert_same(j, p)
    assert_same(jbox, pbox)
    assert sorted(pbox) == list(range(nchildren))
    want = sum(_vals(1, 100 + c, 64) for c in range(nchildren))
    np.testing.assert_array_equal(p[0][5], want)


def test_spawn_multiple_appnum(env):
    def app(world, lib, box):
        def make(tag):
            def child(cw):
                parent = _parent(lib)
                box[cw.rank] = (tag, lib.mpi.Get_appnum(), cw.size,
                                parent.remote_size)
                parent.barrier()
            return child

        inter, errs = lib.sp.comm_spawn_multiple(
            world, [(make("a"), [], 2), (make("b"), [], 1),
                    (make("c"), [], 2)], root=1)
        inter.barrier()
        return (list(errs), inter.remote_size, lib.mpi.Get_appnum())

    (j, jbox), (p, pbox) = _both(2, app)
    assert_same(j, p)
    assert_same(jbox, pbox)
    assert [pbox[r][:2] for r in range(5)] == [
        ("a", 0), ("a", 0), ("b", 1), ("c", 2), ("c", 2)]
    assert p[0][2] is None        # a parent was not spawned


@pytest.mark.parametrize("child_high", [True, False])
def test_merge_after_spawn(env, child_high):
    def app(world, lib, box):
        def child(cw):
            merged = _parent(lib).merge(high=child_high)
            box[cw.rank] = (merged.rank, merged.size,
                            merged.allgather(np.array([cw.u.world_rank],
                                                      np.int64)),
                            merged.allreduce(_vals(3, 50 + cw.rank, 16)))
            merged.barrier()     # the box is written before the parents end

        inter, _ = lib.sp.comm_spawn(world, child, maxprocs=3)
        merged = inter.merge(high=False)
        out = (merged.rank, merged.size,
               merged.allgather(np.array([world.u.world_rank], np.int64)),
               merged.allreduce(_vals(3, world.rank, 16)))
        merged.barrier()
        return out

    (j, jbox), (p, pbox) = _both(2, app)
    assert_same(j, p)
    assert_same(jbox, pbox)
    assert p[0][1] == 5


def test_ports_through_the_name_service(env):
    def app(world, lib, box):
        svc = f"torch-ports-{lib.name}"
        half = world.size // 2
        server = world.rank < half
        local = world.split(0 if server else 1, world.rank)
        if server:
            port = "mv2t-port:0:0"      # significant at the root only
            if local.rank == 0:
                port = lib.sp.open_port(world.u)
                lib.ns.publish_name(world.u, svc, port)
            world.barrier()
            inter = lib.sp.comm_accept(port, local, 0)
        else:
            world.barrier()
            port = lib.ns.lookup_name(world.u, svc)
            inter = lib.sp.comm_connect(port, local, 0)
        out = inter.allreduce(_vals(4, world.rank, 32))
        sizes = (inter.size, inter.remote_size,
                 list(inter.remote_group.world_ranks))
        inter.disconnect()
        world.barrier()
        if server and local.rank == 0:
            lib.ns.unpublish_name(world.u, svc)
            lib.sp.close_port(world.u, port)
        return sizes, out, port.split(":")[:2]

    (j, _), (p, _) = _both(4, app)
    assert_same(j, p)


def test_name_service_error_classes(env):
    def app(world, lib, box):
        svc = f"torch-ephemeral-{lib.name}"
        codes = []
        if world.rank == 0:
            lib.ns.publish_name(world.u, svc, "mv2t-port:0:1")
            got = lib.ns.lookup_name(world.u, svc)
            lib.ns.unpublish_name(world.u, svc)
            for call in (lambda: lib.ns.lookup_name(world.u, svc),
                         lambda: lib.ns.unpublish_name(world.u, svc),
                         lambda: lib.sp.comm_accept(
                             "not-a-port", world.u.comm_self, 0),
                         lambda: lib.sp.comm_accept(
                             "mv2t-port:0:12345", world.u.comm_self, 0)):
                try:
                    call()
                except Exception as e:      # noqa: BLE001
                    codes.append(e.error_class)
            return got, codes
        return None

    (j, _), (p, _) = _both(1, app)
    assert_same(j, p)
    e = port_errors
    assert p[0][1] == [e.MPI_ERR_NAME, e.MPI_ERR_SERVICE, e.MPI_ERR_PORT,
                       e.MPI_ERR_PORT]


def test_spawned_rank_claims_the_spawn_context(env):
    """A spawned rank's own comms never take its spawn intercomm's
    context id: the child claims it in its mask (the JAX child's private
    dup gets the same id as its intercomm, where matching on a shared
    id and comm rank can cross the two)."""
    box = {}

    def child(cw):
        parent = _parent(PORT)
        box[cw.rank] = (parent.context_id, parent.local_comm.context_id,
                        cw.dup().context_id)
        parent.barrier()

    def app(world):
        inter, _ = port_sp.comm_spawn(world, child, maxprocs=2)
        inter.barrier()
        return inter.context_id

    got = run_ranks(2, app, device="cpu", timeout=TIMEOUT)
    for ctx, local, dup in box.values():
        assert ctx == got[0] and len({ctx, local, dup}) == 3


def test_spaconacc(env):
    """MPICH spawn/spaconacc: a parent spawns a child, sends it a port
    name over the spawn intercomm, and the two connect and accept
    through that port over COMM_SELF."""
    def app(world, lib, box):
        def child(cw):
            parent = _parent(lib)
            n = np.zeros(1, np.int64)
            parent.recv(n, 0, tag=1)
            name = np.zeros(int(n[0]), np.uint8)
            parent.recv(name, 0, tag=2)
            port = name.tobytes().decode()
            inter = lib.sp.comm_connect(port, cw.u.comm_self, 0)
            got = np.zeros(4, np.int64)
            inter.recv(got, 0, tag=3)
            inter.send(got * 2, 0, tag=4)
            box["child"] = (port.split(":")[0], got, inter.remote_size)
            inter.disconnect()
            parent.disconnect()

        spawn_inter, _ = lib.sp.comm_spawn(world, child, maxprocs=1)
        port = lib.sp.open_port(world.u)
        raw = np.frombuffer(port.encode(), np.uint8).copy()
        spawn_inter.send(np.array([raw.size], np.int64), 0, tag=1)
        spawn_inter.send(raw, 0, tag=2)
        inter = lib.sp.comm_accept(port, world.u.comm_self, 0)
        inter.send(_vals(5, 0, 4), 0, tag=3)
        back = np.zeros(4, np.int64)
        inter.recv(back, 0, tag=4)
        inter.disconnect()
        lib.sp.close_port(world.u, port)
        spawn_inter.disconnect()
        return back

    (j, jbox), (p, pbox) = _both(1, app)
    assert_same(j, p)
    assert_same(jbox, pbox)
    np.testing.assert_array_equal(p[0], 2 * _vals(5, 0, 4))


def test_spaiccreate(env):
    """MPICH spawn/spaiccreate: world rank 0 spawns from COMM_SELF and
    merges with its children; an intercomm then joins that group and
    world rank 1, which never met the children (it learns their node
    names through the bridge)."""
    def app(world, lib, box):
        def child(cw):
            merged = _parent(lib).merge(high=True)
            ic = lib.ic.intercomm_create(merged, 0, cw, 0, tag=12)
            out = ic.allreduce(_vals(6, 10 + cw.rank, 8))
            box[cw.rank] = (merged.rank, merged.size, ic.size,
                            ic.remote_size, out)
            ic.barrier()

        if world.rank == 0:
            inter, _ = lib.sp.comm_spawn(world.u.comm_self, child,
                                         maxprocs=2)
            merged = inter.merge(high=False)
            ic = lib.ic.intercomm_create(merged, 0, world, 1, tag=12)
        else:
            ic = lib.ic.intercomm_create(world.u.comm_self, 0, world, 0,
                                         tag=12)
        out = ic.allreduce(_vals(6, world.rank, 8))
        ic.barrier()
        return (ic.size, ic.remote_size,
                list(ic.remote_group.world_ranks), out,
                world.u.node_ids[:4])

    (j, jbox), (p, pbox) = _both(2, app)
    assert_same(j, p)
    assert_same(jbox, pbox)
    assert p[1][:2] == (1, 3)


def test_taskmaster(env):
    """MPICH spawn/taskmaster: every rank spawns one child from
    COMM_SELF three times in a row, trades a value with it and
    disconnects."""
    def app(world, lib, box):
        def child(cw):
            parent = _parent(lib)
            v = np.zeros(2, np.int64)
            parent.recv(v, 0, tag=0)
            parent.send(v + cw.u.world_rank, 0, tag=0)
            parent.disconnect()

        got = []
        for i in range(3):
            inter, _ = lib.sp.comm_spawn(world.u.comm_self, child,
                                         maxprocs=1)
            inter.send(_vals(7, 10 * world.rank + i, 2), 0, tag=0)
            back = np.zeros(2, np.int64)
            inter.recv(back, 0, tag=0)
            got.append(int((back - _vals(7, 10 * world.rank + i, 2))[0]))
            inter.disconnect()
        # which rank's child gets which proc id is a race between the
        # ranks; the set of ids is not
        ids = world.allgather(np.array(got, np.int64))
        return sorted(int(x) for x in ids)

    (j, _), (p, _) = _both(2, app)
    assert_same(j, p)
    # six children, proc ids 2..7, each seen once
    assert p[0] == p[1] == list(range(2, 8))


def test_multiple_ports(env):
    """MPICH spawn/multiple_ports: rank 0 opens two ports and accepts on
    each in turn; ranks 1 and 2 each connect to one of them."""
    def app(world, lib, box):
        if world.rank == 0:
            ports = [lib.sp.open_port(world.u) for _ in range(2)]
            for k, port in enumerate(ports):
                raw = np.frombuffer(port.encode(), np.uint8).copy()
                world.send(np.array([raw.size], np.int64), k + 1, tag=1)
                world.send(raw, k + 1, tag=2)
            out = []
            for port in ports:
                ic = lib.sp.comm_accept(port, world.u.comm_self, 0)
                v = np.zeros(3, np.int64)
                ic.recv(v, 0, tag=3)
                out.append(v)
                ic.disconnect()
                lib.sp.close_port(world.u, port)
            return out
        n = np.zeros(1, np.int64)
        world.recv(n, 0, tag=1)
        raw = np.zeros(int(n[0]), np.uint8)
        world.recv(raw, 0, tag=2)
        # both connect at once: an accept matches only its own port's tag
        ic = lib.sp.comm_connect(raw.tobytes().decode(), world.u.comm_self,
                                 0)
        ic.send(_vals(8, world.rank, 3), 0, tag=3)
        ic.disconnect()
        return None

    (j, _), (p, _) = _both(3, app)
    assert_same(j, p)
    np.testing.assert_array_equal(p[0][1], _vals(8, 2, 3))


def test_disconnect_reconnect(env):
    """MPICH spawn/disconnect_reconnect: the parents spawn children, send
    them a port name, disconnect, then accept and connect again through
    the port and talk over the new intercomm, twice."""
    def app(world, lib, box):
        def child(cw):
            parent = _parent(lib)
            n = np.zeros(1, np.int64)
            parent.bcast(n, root=0)
            raw = np.zeros(int(n[0]), np.uint8)
            parent.bcast(raw, root=0)
            parent.disconnect()
            port = raw.tobytes().decode()
            outs = []
            for i in range(2):
                ic = lib.sp.comm_connect(port, cw, 0)
                outs.append(ic.allreduce(_vals(9, 100 * i + cw.rank, 4)))
                if i == 1:
                    box[cw.rank] = outs     # before the parents' last wait
                ic.disconnect()

        inter, _ = lib.sp.comm_spawn(world, child, maxprocs=2)
        port = lib.sp.open_port(world.u) if world.rank == 0 else ""
        raw = np.frombuffer(port.encode(), np.uint8).copy()
        root = lib.st.ROOT if world.rank == 0 else lib.st.PROC_NULL
        inter.bcast(np.array([raw.size], np.int64), root=root)
        inter.bcast(raw, root=root)
        inter.disconnect()
        outs = []
        for i in range(2):
            ic = lib.sp.comm_accept(port, world, 0)
            outs.append(ic.allreduce(_vals(9, 100 * i + world.rank, 4)))
            ic.disconnect()
        if world.rank == 0:
            lib.sp.close_port(world.u, port)
        return outs

    (j, jbox), (p, pbox) = _both(3, app)
    assert_same(j, p)
    assert_same(jbox, pbox)


def test_mpi_surface_in_rank_threads(env):
    """The ``mpi`` calls resolve to the calling rank thread's universe:
    spawn, parent, appnum, ports and names, intercomm create and merge,
    as the JAX package's do; Comm_join raises MPI_ERR_OTHER."""
    def app(world, lib, box):
        m = lib.mpi
        svc = f"torch-surface-{lib.name}"

        def child(cw):
            parent = m.Comm_get_parent()
            box[cw.rank] = (m.Get_appnum(), parent.remote_size)
            m.Intercomm_merge(parent, True).barrier()

        inter, _ = m.Comm_spawn(child, maxprocs=2, comm=world)
        merged = m.Intercomm_merge(inter, False)
        merged.barrier()
        if world.rank == 0:
            port = m.Open_port()
            m.Publish_name(svc, port)
            found = m.Lookup_name(svc)
            m.Unpublish_name(svc, port)
            m.Close_port(port)
            ok = found == port
        else:
            ok = True
        local = world.split(world.rank % 2, world.rank)
        ic = m.Intercomm_create(local, 0, world, 1 - world.rank % 2, 3)
        return (ok, m.Comm_get_parent(), merged.size, ic.remote_size)

    (j, jbox), (p, pbox) = _both(2, app)
    assert_same(j, p)
    assert_same(jbox, pbox)
    with pytest.raises(port_errors.MPIException) as ei:
        port_mpi.Comm_join(0)
    assert ei.value.error_class == port_errors.MPI_ERR_OTHER


@pytest.mark.parametrize("steps", [
    [("extend", 4, ["__node_0", "__node_0"])],
    [("extend", 6, ["hostA", "hostB", "hostA"])],
    [("learn", [(5, "__node_1"), (9, "hostC"), (7, "__node_-3")])],
    [("extend", 4, ["x"]), ("learn", [(4, "x"), (8, "y")]),
     ("extend", 9, ["y", "z"])],
], ids=["same_node", "named", "learn", "mixed"])
def test_proc_table_growth_matches(steps):
    """``extend_procs``, ``learn_procs`` and ``node_name_of`` build the
    same table from the same inputs in both packages."""
    import torch
    ju = jax_uni.Universe(1, 4, [0, 0, 1, 1])
    pu = port_uni.Universe(1, 4, torch.device("cpu"), [0, 0, 1, 1])
    for u in (ju, pu):
        u.node_name_to_id = {"__node_0": 0, "__node_1": 1}
        for step in steps:
            if step[0] == "extend":
                u.extend_procs(step[1], step[2])
            else:
                u.learn_procs(step[1])
    assert ju.node_ids == pu.node_ids
    assert ju.node_name_to_id == pu.node_name_to_id
    for pid in range(len(pu.node_ids) + 2):
        assert ju.node_name_of(pid) == pu.node_name_of(pid)
    assert (ju.my_node, ju.ports, ju.parent_intercomm) == \
        (pu.my_node, pu.ports, pu.parent_intercomm)


def test_kvs_spawn_verbs_across_packages():
    """The port's KVS server starts the ``__next_proc`` watermark at the
    job's size, as the JAX server does; ``peek``, ``delete`` and named
    fence groups with their own counts work across the packages'
    clients and servers."""
    import threading
    for srv_mod, cli_mod in ((port_kvs, jax_kvs), (jax_kvs, port_kvs),
                             (port_kvs, port_kvs)):
        srv = srv_mod.KVSServer(3)
        try:
            a, b = (cli_mod.KVSClient(srv.address) for _ in range(2))
            assert a.peek("__next_proc") == "3"
            assert a.add("__next_proc", 2) - 2 == 3
            a.put("k", "v")
            assert b.peek("k") == "v"
            b.delete("k")
            assert a.peek("k") is None
            # a group of two fences on its own, in a job of three
            t = threading.Thread(target=lambda: b.fence(
                group="spawn-3", count=2, cards={"node-4": "n"}))
            t.start()
            a.fence(group="spawn-3", count=2, cards={"node-3": "n"})
            t.join(10)
            assert not t.is_alive()
            assert a.get_many(["node-3", "node-4"]) == ["n", "n"]
            a.close()
            b.close()
        finally:
            srv.shutdown()


# ---------------------------------------------------------------------------
# process mode
# ---------------------------------------------------------------------------

def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie left unreaped counts as gone too
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_process_spawn_job():
    """``mpirun -np 2`` of ``progs/spawn_parent.py``: a spawn of a
    missing program fails with MPI_ERR_SPAWN on both parents, then two
    children come up (appnum 0 and 1), run the intercomm collectives,
    merge and disconnect; rank 0 prints No Errors and SPAWN_JSON, and no
    child outlives the job."""
    import json
    prog = os.path.join(REPO, "mvapich2_tpu_torch", "progs",
                        "spawn_parent.py")
    cmd = [sys.executable, "-m", "mvapich2_tpu_torch.run", "-np", "2",
           "--timeout", "100", sys.executable, prog, "--big", "65536",
           "--iters", "2", "--bad-first"]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "No Errors" in r.stdout
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("SPAWN_JSON ")][0]
    got = json.loads(line.split(" ", 1)[1])
    assert got["bad_spawn_class"] == port_errors.MPI_ERR_SPAWN
    assert len(got["child_pids"]) == 2 and got["spawn_s"] > 0
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in got["child_pids"]) \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(_alive(p) for p in got["child_pids"])


@pytest.mark.slow
def test_process_spawn_job_beside_jax():
    """The JAX package's spawn job (``tests/progs/spawn_parent_prog.py``)
    and the port's print No Errors alike."""
    outs = []
    for pkg, prog in (
            ("mvapich2_tpu", os.path.join(REPO, "tests", "progs",
                                          "spawn_parent_prog.py")),
            ("mvapich2_tpu_torch", os.path.join(
                REPO, "mvapich2_tpu_torch", "progs", "spawn_parent.py"))):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.run", "-np", "2",
                            sys.executable, prog], cwd=REPO,
                           capture_output=True, text=True, timeout=180)
        assert r.returncode == 0, f"{pkg}: {r.stdout}\n{r.stderr}"
        outs.append("No Errors" in r.stdout)
    assert outs == [True, True]
