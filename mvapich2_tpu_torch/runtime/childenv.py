"""The environment of a rank process (the port's counterpart of the JAX
package's ``runtime/childenv.py``).

A rank process inherits the launcher's environment plus the bootstrap
variables the light boot reads (``runtime/boot.py``): ``MV2T_RANK``,
``MV2T_SIZE``, ``MV2T_KVS`` (the job's KVS address) and, under
``--fake-nodes``, ``MV2T_FAKE_NODE``. The JAX package forces
``JAX_PLATFORMS=cpu`` here because a TPU runtime serves a single client;
CUDA has no such limit, so the port sets no JAX variable and leaves
``CUDA_VISIBLE_DEVICES`` alone: a rank's own code sees the card. The
port's own calls in a rank process still run the host tier (a
process-mode COMM_WORLD has no device channel). The directory that holds
the launcher's ``mvapich2_tpu_torch`` leads ``PYTHONPATH``, so a rank
program imports the same package wherever its file lies.
"""

from __future__ import annotations

import os
from typing import Optional

# the directory that holds the mvapich2_tpu_torch package
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rank_env(rank: int, size: int, kvs_addr: str,
             fake_node: Optional[int] = None,
             extra: Optional[dict] = None) -> dict:
    """The environment of rank ``rank`` of a ``size``-rank job."""
    env = dict(os.environ)
    env["MV2T_RANK"] = str(rank)
    env["MV2T_SIZE"] = str(size)
    env["MV2T_KVS"] = kvs_addr
    env["PYTHONPATH"] = os.pathsep.join(
        [PKG_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    if fake_node is not None:
        env["MV2T_FAKE_NODE"] = f"fakenode{fake_node}"
    if extra:
        env.update(extra)
    return env
