"""``mpirun``: the process launcher of the port (a trimmed copy of the
JAX package's ``runtime/launcher.py``).

    python -m mvapich2_tpu_torch.run -np N [--fake-nodes 0,0,1,1]
        [--timeout S] python prog.py [args]
    python -m mvapich2_tpu_torch.run -np N --vpod python prog.py [args]

Process mode (``launch``): start the job's KVS (``runtime/kvs.py``), one
OS process a rank with the bootstrap environment
(``runtime/childenv.py``), stdio inherited, and reap their exit codes:
a rank that exits nonzero kills the job (SIGTERM, a grace period, then
SIGKILL), and an ``MPI_Abort(code)`` seen on the KVS kills it with exit
code ``code``. Whatever shared-memory segments the job's ranks left in
``/dev/shm`` (rings, flags, spill and rendezvous files, the leaders'
arenas) are removed when it ends, also when it was killed
(``sweep_segments``). This path imports no torch: the rank processes
pay that import. A rank's program calls ``mpi.Init()`` and runs on the
host tier (``runtime/bootstrap.py``).

``--vpod`` (``launch_vpod``): N rank threads in this process, COMM_WORLD
bound one to one to the N virtual ranks of a mesh on ``cuda:0``
(``local_universe(N, device_mesh=make_mesh((N,), ("x",), "cuda:0"))``),
so the program's collectives take the device channel and its kernels;
``mpi.Init()`` in a rank thread resolves to that thread's universe.
``MV2T_VPOD_REAL=0`` asks for the CPU instead (the JAX package's knob,
whose default is the other way round there: it re-executes itself onto
a virtual CPU mesh unless the variable asks for real devices). Without
a CUDA device and without that variable the launch raises; it never
carries on on the CPU.

``--hostfile``/``--map`` (the multi-host tree) and ``--ft`` (ULFM) are
not ported: they exit with code 2 and say so.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

from .boot import shm_base_dir
from .childenv import rank_env
from .kvs import KVSServer


def _abort_exit_code(aborted: Optional[str], default: int = 1) -> int:
    """Exit code of an MPI_Abort-ed job: the errorcode travels in the
    abort event (the launcher's kill can beat the aborting rank to its
    own exit). Codes that cannot be an exit status (<= 0, >= 256) give
    the generic failure code."""
    m = re.search(r"MPI_Abort\((-?\d+)\)", aborted or "")
    code = int(m.group(1)) if m else default
    return code if 0 < code < 256 else 1


def _kill_all(procs: List[subprocess.Popen]) -> None:
    """SIGTERM, a grace period, SIGKILL stragglers."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()


def sweep_segments(pids: List[int]) -> List[str]:
    """Remove the shared-memory files the rank processes ``pids`` created
    (``mv2t-shm-<pid>-*``: segments, flags, doorbells, spill and
    rendezvous files; ``mv2t-arena-<pid>-*``: a leader's scratch arena,
    ``transport/arena.py``), however the job ended; returns the paths
    removed."""
    base = shm_base_dir()
    gone = []
    for pid in pids:
        for stem in ("shm", "arena"):
            for path in glob.glob(os.path.join(base,
                                               f"mv2t-{stem}-{pid}-*")):
                try:
                    os.unlink(path)
                    gone.append(path)
                except OSError:
                    pass
    return gone


def launch(nranks: int, argv: List[str], env_extra: Optional[dict] = None,
           fake_nodes: Optional[List[int]] = None,
           timeout: Optional[float] = None) -> int:
    """Run ``argv`` as ``nranks`` rank processes; returns the job's exit
    code (the largest of the ranks', or the abort code)."""
    srv = KVSServer(nranks)
    procs: List[subprocess.Popen] = []
    # a soft kill of the launcher takes the ranks with it (an orphaned
    # rank would wait in its progress loop forever)
    prev_term = signal.getsignal(signal.SIGTERM)

    def _on_term(signum, frame):
        _kill_all(procs)
        raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass    # not the main thread: the caller owns signal handling
    try:
        for r in range(nranks):
            env = rank_env(r, nranks, srv.address,
                           None if fake_nodes is None else fake_nodes[r],
                           env_extra)
            procs.append(subprocess.Popen(argv, env=env))
        deadline = time.monotonic() + timeout if timeout else None
        exit_codes: List[Optional[int]] = [None] * nranks
        while any(c is None for c in exit_codes):
            for i, p in enumerate(procs):
                if exit_codes[i] is None:
                    exit_codes[i] = p.poll()
            if srv.state.aborted is not None:
                # MPI_Abort through the KVS: kill the whole job at once
                print(f"mv2t-launch: {srv.state.aborted}", file=sys.stderr)
                _kill_all(procs)
                codes = [p.wait() for p in procs]
                if re.search(r"MPI_Abort\(", srv.state.aborted or ""):
                    return _abort_exit_code(srv.state.aborted)
                pos = [c for c in codes if c > 0]
                return max(pos) if pos else 1
            if any(c is not None and c != 0 for c in exit_codes):
                _kill_all(procs)
                return max(c or 0 for c in exit_codes if c is not None) or 1
            if deadline and time.monotonic() > deadline:
                _kill_all(procs)
                raise TimeoutError(f"job exceeded {timeout}s")
            time.sleep(0.01)
        return max(c or 0 for c in exit_codes)
    finally:
        try:
            signal.signal(signal.SIGTERM, prev_term)
        except ValueError:
            pass
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        sweep_segments([p.pid for p in procs])
        srv.shutdown()


def launch_vpod(nranks: int, argv: List[str],
                timeout: Optional[float] = None) -> int:
    """Virtual-pod mode: ``nranks`` rank threads of this process, each
    running the python program ``argv`` (its leading interpreter token
    dropped) with ``mpi.Init()`` resolving to the thread's universe, and
    COMM_WORLD bound one to one to a mesh of ``nranks`` virtual ranks on
    ``cuda:0`` (the CPU under ``MV2T_VPOD_REAL=0``). Each rank thread runs
    on a CUDA stream of its own, synchronized before the thread ends; a
    failing rank aborts the device rendezvous and wakes every engine.
    Returns the largest rank exit code."""
    prog = list(argv)
    if prog and os.path.basename(prog[0]).startswith("python"):
        prog = prog[1:]
    if not prog:
        print("mpirun --vpod: need a python script", file=sys.stderr)
        return 2

    import runpy
    import traceback

    import torch

    from ..parallel.mesh import make_mesh
    from .universe import local_universe, set_universe
    device = "cpu" if os.environ.get("MV2T_VPOD_REAL") == "0" \
        else "cuda:0"
    mesh = make_mesh((nranks,), ("x",), device)   # raises without CUDA
    universes = local_universe(nranks, device_mesh=mesh)
    dev = mesh.device
    sys.argv = prog
    codes: List[int] = [0] * nranks

    def abort() -> None:
        ch = universes[0].comm_world.device_channel
        if ch is not None:
            ch.abort()           # break the device rendezvous
        for u in universes:
            u.engine.wakeup()

    def run() -> None:
        runpy.run_path(prog[0], run_name="__main__")

    def body(r: int) -> None:
        set_universe(universes[r])
        try:
            if dev.type == "cuda":
                stream = torch.cuda.Stream(dev)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    run()
                stream.synchronize()
            else:
                run()
        except SystemExit as e:
            codes[r] = 1 if isinstance(e.code, str) else int(e.code or 0)
        except BaseException:   # noqa: BLE001 - a rank error is a job error
            traceback.print_exc()
            codes[r] = 1
        finally:
            if codes[r] != 0:
                abort()          # release peers blocked on this rank
            set_universe(None)

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"vpod-rank-{r}")
               for r in range(nranks)]
    for t in threads:
        t.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    for t in threads:
        t.join(None if deadline is None
               else max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            print(f"mpirun --vpod: {t.name} hung past {timeout}s",
                  file=sys.stderr)
            abort()
            return 1
    for u in universes:
        u.finalize()
    return max(codes)


# flags of the JAX launcher whose paths are not ported, and what waits
_NOT_PORTED = {
    "hostfile": "--hostfile/--map (the multi-host launch tree: "
                "launch_tree, hostfile.py, mpispawn.py, rm.py)",
    "ft": "--ft/--disable-auto-cleanup (ULFM failure events)",
}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="mpirun",
        description="mvapich2-tpu process launcher, PyTorch/CUDA port "
                    "(mpirun_rsh analog)")
    ap.add_argument("-np", "-n", type=int, default=1, dest="np")
    ap.add_argument("--fake-nodes", type=str, default=None,
                    help="comma-separated fake node id per rank "
                         "(emulate several nodes on one host)")
    ap.add_argument("--ft", "--disable-auto-cleanup", action="store_true",
                    dest="ft", help="not ported: exits with code 2")
    ap.add_argument("--vpod", action="store_true",
                    help="virtual-pod mode: rank threads bound one to one "
                         "to a mesh of virtual ranks on cuda:0")
    ap.add_argument("--hostfile", "-f", default=None,
                    help="not ported: exits with code 2")
    ap.add_argument("--map", choices=("block", "cyclic"), default=None,
                    help="not ported: exits with code 2")
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    gap = _NOT_PORTED["hostfile"] if args.hostfile or args.map else \
        _NOT_PORTED["ft"] if args.ft else None
    if gap is not None:
        print(f"mpirun: {gap} is not ported to mvapich2_tpu_torch",
              file=sys.stderr)
        return 2
    if not args.command:
        ap.error("no command given")
    if args.vpod:
        return launch_vpod(args.np, args.command, timeout=args.timeout)
    fake = None
    if args.fake_nodes:
        fake = [int(x) for x in args.fake_nodes.split(",")]
        if len(fake) != args.np:
            ap.error("--fake-nodes length must equal -np")
    return launch(args.np, args.command, fake_nodes=fake,
                  timeout=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
