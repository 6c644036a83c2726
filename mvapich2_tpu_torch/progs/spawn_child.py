"""A child of ``spawn_parent.py`` (started by its ``Comm_spawn_multiple``;
not run by hand): it joins the job through the KVS, sends its pid and
``Get_appnum()`` to parent 0 by an intercomm gather, answers the
parents' intercomm allreduces (its float32 contribution is 100 + its
rank; it checks the parents' sum), merges (high) and allreduces over the
merged comm, and disconnects."""

import argparse
import os
import sys

import numpy as np

from mvapich2_tpu_torch import mpi


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", type=int, default=4 << 20)
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args()
    mpi.Init()
    cw = mpi.COMM_WORLD
    parent = mpi.Comm_get_parent()
    assert parent is not None and parent.is_inter, "no parent intercomm"
    assert cw.size == 2 and mpi.Get_appnum() == cw.rank, \
        (cw.size, mpi.Get_appnum())
    parent.gather(np.array([os.getpid(), mpi.Get_appnum()], np.int64),
                  count=2, root=0)
    want = float(sum(r + 1 for r in range(parent.remote_size)))
    for nbytes in (8, a.big):
        x = np.full(nbytes // 4, 100 + cw.rank, np.float32)
        out = np.empty_like(x)
        for _ in range(a.iters + 1):
            parent.allreduce(x, out)
        assert (out == want).all(), (nbytes, out[:4])
    merged = parent.merge(high=True)
    assert merged.size == parent.remote_size + cw.size
    tot = merged.allreduce(np.ones(4, np.float32))
    assert (tot == merged.size).all(), tot
    parent.disconnect()
    mpi.Finalize()
    sys.exit(0)


if __name__ == "__main__":
    main()
