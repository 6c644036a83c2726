"""The CMA and arena rungs of the port's shared-memory rendezvous
(``transport/arena.py``, ``transport/shm.py``) held against the JAX
package's on the CPU.

* ``ShmArena``: the same allocations, frees, writes and spill-counter
  bumps leave the same bytes in the file and hand out the same offsets as
  the JAX arena; a blob larger than a ring spills into the arena with the
  JAX ``0xFE`` note, the receiver reads it and bumps its counter, and the
  sender's next spill frees the consumed block; with the arena full, the
  ``0xFF`` file note.
* ``sweep_stale`` leaves the same files as the JAX sweep in a directory
  of dead and live creators' files; a leader making its arena removes no
  other file of its directory.
* ``cma_read`` copies a child process's buffer (``process_vm_readv``),
  in one call and in chunks, as the JAX reader does, and counts
  ``rndv_cma_bytes``.
* No ``mv2t-arena-*`` file is left after a job ends normally or by
  ``MPI_Abort(3)``; the leader's arena file is named
  ``mv2t-arena-<pid>-<8 hex>``, the launcher's sweep pattern.

The process-mode jobs under each rung, against the JAX jobs, are in
``tests/test_torch_mpirun_parity.py``.
"""

import glob
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

from mvapich2_tpu.transport import arena as jax_arena
from mvapich2_tpu.transport import shm as jax_shm

from mvapich2_tpu_torch import mpit
from mvapich2_tpu_torch.runtime.boot import shm_base_dir
from mvapich2_tpu_torch.transport import arena as port_arena
from mvapich2_tpu_torch.transport import shm as port_shm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PART = 1 << 20
N_LOCAL = 3


def _ops(mod, path):
    """One arena's life: allocations of several classes, writes, a free
    and a reuse, exhaustion, spill-counter bumps. Returns (offsets, the
    file's bytes)."""
    a = mod.ShmArena(path, N_LOCAL, 1, PART, create=True)
    rng = np.random.default_rng(7)
    offs, hs = [], []
    for n in (1, 64 * 1024, 64 * 1024 + 1, 300 * 1000, 5000):
        h = a.alloc(n)
        hs.append(h)
        offs.append((h.off, h.cls, h.nbytes))
        a.view(h.off, n)[:] = rng.integers(0, 256, n, dtype=np.uint8)
    a.free(hs[1])
    h = a.alloc(1000)                   # the freed 64 KiB block, reused
    offs.append((h.off, h.cls))
    offs.append(a.alloc(PART) is None)  # more than what is left
    offs.append(a.alloc(2 * PART) is None)   # more than the partition
    for src, dst in ((0, 1), (0, 1), (2, 1), (1, 0)):
        a.bump_spill(src, dst)
    offs.append([a.spill_consumed(s, d) for s in range(N_LOCAL)
                 for d in range(N_LOCAL)])
    offs.append((a.outstanding, a.bytes_in_use))
    a.close()
    with open(path, "rb") as f:
        data = f.read()
    os.unlink(path)
    return offs, data


def test_rung_cvars_are_the_jax_ones():
    """USE_CMA, ARENA_BYTES, RNDV_CHUNK and RNDV_DEPTH: the JAX names,
    defaults and types."""
    from mvapich2_tpu.utils.config import get_config as jax_config
    from mvapich2_tpu_torch.utils import config
    jax_cvars = jax_config().cvars()
    for name in ("USE_CMA", "ARENA_BYTES", "RNDV_CHUNK", "RNDV_DEPTH"):
        mine = config.PROCESS_CVARS[name]
        assert mine == jax_cvars[name].default, name
        assert type(mine) is jax_cvars[name].typ, name


def test_arena_bytes_equal_jax(tmp_path):
    mine = _ops(port_arena, str(tmp_path / "port"))
    ref = _ops(jax_arena, str(tmp_path / "jax"))
    assert mine[0] == ref[0]
    assert mine[1] == ref[1]


def _spiller(cls, arena, my_i, path):
    """A channel object carrying only what the spill path reads."""
    ch = cls.__new__(cls)
    ch.arena, ch._arena_ready, ch.path = arena, arena is not None, path
    ch.my_rank = ch.my_i = my_i
    ch.local_index = {my_i: my_i}
    ch._spill_lock = threading.Lock()
    ch._spill_seq, ch._spill_pending = {}, {}
    return ch


def test_spill_notes_equal_jax(tmp_path):
    """Each package's sender spills into its arena and the receiver (rank
    1's mapping of the same file) reads the blob back; the notes and the
    file's bytes are the same in both packages."""
    out = {}
    for name, mod, shm in (("port", port_arena, port_shm.ShmChannel),
                           ("jax", jax_arena, jax_shm.ShmChannel)):
        apath = str(tmp_path / f"{name}.arena")
        send_a = mod.ShmArena(apath, 2, 0, PART, create=True)
        recv_a = mod.ShmArena(apath, 2, 1, PART)
        tx = _spiller(shm, send_a, 0, str(tmp_path / name))
        rx = _spiller(shm, recv_a, 1, str(tmp_path / name))
        blobs = [bytes(range(256)) * 400, b"\x07" * 70000]
        notes, back = [], []
        for b in blobs:
            notes.append(tx._spill_oversize(b, 1))
            back.append(rx._consume_spill_note(notes[-1]))
        in_use = send_a.outstanding
        tx._reclaim_spills()            # the receiver consumed both
        freed = send_a.outstanding
        # a full arena: the file note, read back and unlinked
        tx.arena = mod.ShmArena(str(tmp_path / f"{name}.small"), 2, 0,
                                4096, create=True)
        fnote = tx._spill_oversize(blobs[1], 1)
        back.append(rx._consume_spill_note(fnote))
        with open(apath, "rb") as f:
            data = f.read()
        out[name] = (notes, back, in_use, freed, fnote[:1],
                     fnote[1:].decode().startswith(str(tmp_path / name)),
                     os.path.exists(fnote[1:].decode()), data)
    assert out["port"] == out["jax"]
    notes, back = out["port"][:2]
    assert [n[0] for n in notes] == [0xFE, 0xFE]
    assert back[:2] == [bytes(range(256)) * 400, b"\x07" * 70000]
    assert back[2] == b"\x07" * 70000
    # the second spill freed the first block, which the receiver had read
    assert out["port"][2:7] == (1, 0, b"\xff", True, False)


def _dead_pid():
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


STALE_NAMES = ("mv2t-arena-{dead}-0a1b2c3d", "mv2t-shm-{dead}-ab12",
               "mv2t-shm-{dead}-ab12.rget-1-0123abcd",
               "mv2t-arena-{live}-4e5f6a7b", "mv2t-shm-{live}-cd34",
               "mv2t-other-{dead}-x", "arena-{dead}")


def _stale_dir(path, dead):
    os.makedirs(path)
    for name in STALE_NAMES:
        with open(os.path.join(path, name.format(dead=dead,
                                                 live=os.getpid())), "wb"):
            pass


def test_sweep_stale_equal_jax(tmp_path):
    """Each package's sweep in its own copy of one directory: the dead
    creator's arena, ring and RGET files go, the live one's and the
    unmatched names stay, the same in both, and arena_reclaimed_dead
    counts them."""
    dead = _dead_pid()
    left, counts = {}, {}
    before = mpit.pvar("arena_reclaimed_dead").read()
    for name, mod in (("port", port_arena), ("jax", jax_arena)):
        d = str(tmp_path / name)
        _stale_dir(d, dead)
        counts[name] = mod.ShmArena.sweep_stale(d)
        left[name] = sorted(os.listdir(d))
    assert left["port"] == left["jax"]
    assert counts["port"] == counts["jax"] == 3
    assert not any(n.startswith((f"mv2t-arena-{dead}-", f"mv2t-shm-{dead}-"))
                   for n in left["port"])
    assert mpit.pvar("arena_reclaimed_dead").read() - before == 3


def test_leader_arena_sweeps_nothing(tmp_path):
    """A leader's arena goes beside its segment and leaves every other
    file of that directory where it was, a dead job's too: the directory
    is shared, and each job's launcher removes its own files."""
    dead = _dead_pid()
    d = str(tmp_path / "shm")
    _stale_dir(d, dead)
    before = sorted(os.listdir(d))
    ch = port_shm.ShmChannel.__new__(port_shm.ShmChannel)
    ch.path = os.path.join(d, f"mv2t-shm-{os.getpid()}-ef56")
    ch.n_local, ch.my_i = 2, 0
    card = ch._make_arena()
    try:
        apath, part = card.rsplit(":", 1)
        assert re.fullmatch(rf"mv2t-arena-{os.getpid()}-[0-9a-f]{{8}}",
                            os.path.basename(apath))
        assert int(part) == ch.arena.part_bytes
        assert sorted(os.listdir(d)) == sorted(before
                                               + [os.path.basename(apath)])
    finally:
        ch.arena.close(unlink=True)


CHILD = """
import sys
import numpy as np
buf = np.frombuffer(bytes(range(256)) * 1000, dtype=np.uint8).copy()
print(buf.ctypes.data, buf.size, flush=True)
sys.stdin.readline()
"""


def test_cma_read_round_trips():
    """The parent reads the child's 256000-byte buffer with each
    package's reader, in one call and in 4096-byte chunks."""
    p = subprocess.Popen([sys.executable, "-c", CHILD], stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, text=True)
    try:
        addr, n = map(int, p.stdout.readline().split())
        want = np.frombuffer(bytes(range(256)) * 1000, dtype=np.uint8)
        before = mpit.pvar("rndv_cma_bytes").read()
        got = []
        for mod in (port_arena, jax_arena):
            for chunk in (0, 4096):
                out = np.empty(n, dtype=np.uint8)
                mod.cma_read(p.pid, addr, out, chunk=chunk)
                got.append(out)
        assert port_arena.cma_probe(p.pid, addr, 12) == want[:12].tobytes()
    finally:
        p.communicate("\n", timeout=30)
    for out in got:
        np.testing.assert_array_equal(out, want)
    assert mpit.pvar("rndv_cma_bytes").read() - before == 2 * n


ARENA_PROG = """
import os, sys
import numpy as np
from mvapich2_tpu_torch import mpi
mpi.Init()
c = mpi.COMM_WORLD
ch = c.u.shm_channel
# the wiring (the rung agreement) is lazy: wait until both ranks have it
while not c.allreduce(np.array([int(ch._wired)], np.int32), op=mpi.MIN)[0]:
    pass
buf = np.arange(1 << 16, dtype=np.float64)
if c.rank == 0:
    c.send(buf, dest=1, tag=1)
elif c.rank == 1:
    got = np.empty_like(buf)
    c.recv(got, source=0, tag=1)
    assert (got == buf).all()
c.barrier()
if c.rank == 0:
    os.write(1, f"ARENA {ch.arena.path} {ch._arena_ready} "
                f"{ch.cma_ok}\\n".encode())
c.barrier()
if sys.argv[1] == "abort":
    if c.rank == 1:
        mpi.Abort(c, 3)
    c.recv(np.empty(4), source=1, tag=3)      # never matched
mpi.Finalize()
"""


@pytest.mark.parametrize("how", ["normal", "abort"])
def test_no_arena_file_left(tmp_path, how):
    """The leader made its arena under the launcher's sweep pattern, the
    node agreed it (CMA off here), and no ``mv2t-arena-*`` file of the
    job's ranks is left however the job ends."""
    prog = tmp_path / "prog.py"
    prog.write_text(ARENA_PROG)
    env = dict(os.environ, MV2T_USE_CMA="0")
    env.pop("MV2T_KVS", None)
    r = subprocess.run([sys.executable, "-m", "mvapich2_tpu_torch.run",
                        "-np", "2", sys.executable, str(prog), how],
                       cwd=REPO, capture_output=True, text=True, timeout=60,
                       env=env)
    assert r.returncode == (0 if how == "normal" else 3), r.stderr
    line = [ln.split() for ln in r.stdout.splitlines()
            if ln.startswith("ARENA ")]
    assert len(line) == 1
    _, path, ready, cma = line[0]
    assert (ready, cma) == ("True", "False")
    m = re.fullmatch(r"mv2t-arena-(\d+)-[0-9a-f]{8}", os.path.basename(path))
    assert m and os.path.dirname(path) == shm_base_dir(), path
    assert not os.path.exists(path)
    assert glob.glob(os.path.join(shm_base_dir(),
                                  f"mv2t-arena-{m.group(1)}-*")) == []


def _job(args, tag, **extra):
    env = dict(os.environ, **extra)
    env.pop("MV2T_KVS", None)
    r = subprocess.run([sys.executable, "-m", "mvapich2_tpu_torch.run",
                        *args], cwd=REPO, capture_output=True, text=True,
                       timeout=60, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(tag + " ")]
    assert len(lines) == 1, r.stdout
    return json.loads(lines[0].split(" ", 1)[1])


def test_pingpong_lower_rungs_in_one_job():
    """``pingpong.py --rungs arena,file``: after the default run (CMA,
    which this machine's probe agrees), the shm ping-pong runs again
    under the arena (the pipelined rendezvous: 64 KiB in four chunks of
    16 KiB) and under the file rung, each with the counters of that rung only."""
    out = _job(["-np", "2", sys.executable,
                os.path.join("mvapich2_tpu_torch", "progs", "pingpong.py"),
                "--sizes", "1,65536", "--iters", "2", "--rungs",
                "arena,file"], "PINGPONG_JSON", MV2T_RNDV_CHUNK="16384")
    assert out["rungs"] == {"cma": True, "arena": True}
    assert out["pvars_rank0"]["rndv_cma_bytes"] > 0
    runs = out["rung_runs"]
    assert list(runs) == ["arena", "file"]
    assert runs["arena"]["rungs"] == {"cma": False, "arena": True}
    assert runs["file"]["rungs"] == {"cma": False, "arena": False}
    pa, pf = runs["arena"]["pvars_rank0"], runs["file"]["pvars_rank0"]
    assert pa["rndv_cma_bytes"] == 0 and pa["arena_allocs"] > 0 \
        and pa["rndv_pipeline_chunks"] > 0
    assert pf["rndv_cma_bytes"] == pf["arena_allocs"] == \
        pf["rndv_pipeline_chunks"] == 0
    assert pf["pt2pt_rndv_sent"] == pa["pt2pt_rndv_sent"] > 0
    for run in runs.values():
        assert set(run["pingpong_us"]["shm"]) == {"1", "65536"}


def test_shm_rndv_bench_splits():
    """``bench/shm_rndv.py`` on two ranks: every rung the node offers
    (CMA here), the CMA rendezvous split into its parts, and the parts
    of a CMA pull alone."""
    out = _job(["-np", "2", sys.executable, "-m",
                "mvapich2_tpu_torch.bench.shm_rndv", "--sizes",
                "65536,262144", "--iters", "2"], "SHM_RNDV_JSON")
    assert list(out["rungs"]) == ["cma", "arena", "file"]
    for rung, per in out["rungs"].items():
        assert set(per) == {"65536", "262144"}
        for split in per.values():
            assert split["messages_split"] == 2
            assert split["one_way"] > 0 and split["pack"] > 0
            if rung != "arena":
                assert {"expose", "rts_hop", "pull", "unpack",
                        "fin_hop"} <= set(split)
    assert set(out["cma_pull_parts_us"]) == {
        "pull_buffer", "pull_buffer_kept", "alloc_touch", "copy_kept",
        "cma_chunked_reused", "cma_one_call_reused", "memcpy"}
