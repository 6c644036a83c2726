"""The in-process rank harness (counterpart of the JAX package's
``runtime/universe.py`` ``local_universe``/``run_ranks``).

Ranks are threads of one process, each with its own ``Universe`` and
``COMM_WORLD``, bound to one device: through the slot channel, one to
one to the virtual devices of a ``device_mesh`` (``parallel/mesh.py``,
1-D or multi-axis), or ``k`` ranks to each of its devices (the fold
channel).
The device is ``cuda:0`` unless the caller names another; without a
CUDA device the caller must ask for the CPU (``device="cpu"``, or a mesh
made on the CPU), or the harness raises. The host transport
(point-to-point, host collectives) is not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Union

import torch

from ..core.comm import Comm

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` -> ``cuda:0``. A CUDA device that is not present raises:
    the harness never carries on quietly on the CPU."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Universe:
    """One rank's world: its rank, the world size, the device its
    collectives run on, and its COMM_WORLD."""

    def __init__(self, rank: int, size: int, device: torch.device):
        self.rank = rank
        self.size = size
        self.device = device
        self.comm_world = Comm(rank, size)


def local_universe(nranks: int, device: DeviceLike = None,
                   device_mesh=None) -> List[Universe]:
    """Build ``nranks`` thread-rank universes. With ``device_mesh`` (a
    ``parallel.mesh.Mesh``) of ``nranks`` devices, their COMM_WORLDs bind
    the 1:1 mesh channel on the mesh's device; of fewer devices that
    divide the ranks, the fold channel; without one (or with one
    device) they share ``device`` through the slot channel
    (coll/device.py ``bind_universes``)."""
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1, got {nranks}")
    if device_mesh is not None:
        if device is not None and resolve_device(device) != \
                device_mesh.device:
            raise ValueError(f"device {device} differs from the mesh's "
                             f"{device_mesh.device}")
        dev = device_mesh.device
    else:
        dev = resolve_device(device)
    universes = [Universe(r, nranks, dev) for r in range(nranks)]
    from ..coll.device import bind_universes
    bind_universes(universes, dev, device_mesh)
    return universes


def run_ranks(nranks: int, fn: Callable, *args, device: DeviceLike = None,
              timeout: float = 120.0, device_mesh=None) -> List:
    """Run ``fn(comm_world, *args)`` on every rank (threads); return the
    per-rank results. ``device_mesh``: bind the ranks one to one to the
    mesh's virtual devices (see :func:`local_universe`). On a CUDA
    device each rank thread runs on its own stream, synchronized before
    the rank finishes. A rank's exception aborts the device rendezvous
    (its peers fail instead of hanging) and is re-raised with its rank
    noted; a rank still running after ``timeout`` seconds raises
    ``TimeoutError``."""
    universes = local_universe(nranks, device, device_mesh)
    dev = universes[0].device
    results: List = [None] * nranks
    errors: List[Optional[BaseException]] = [None] * nranks

    def body(r: int):
        comm = universes[r].comm_world
        try:
            if dev.type == "cuda":
                stream = torch.cuda.Stream(dev)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    results[r] = fn(comm, *args)
                stream.synchronize()
            else:
                results[r] = fn(comm, *args)
        except BaseException as e:  # noqa: BLE001 - reported by run_ranks
            errors[r] = e
            comm.device_channel.abort()   # break the rendezvous

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"rank-{r}")
               for r in range(nranks)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            universes[0].comm_world.device_channel.abort()
            raise TimeoutError(
                f"rank thread {t.name} did not finish within {timeout}s "
                f"(errors so far: {[e for e in errors if e]})")
    for r, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"rank {r} failed: {e!r}") from e
    return results
