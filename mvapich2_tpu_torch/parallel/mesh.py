"""Device meshes of the port (counterpart of the JAX package's
``parallel/mesh.py`` ``make_mesh``, ``mesh_shape_for`` and ``MeshComm``).

A mesh here is ``size`` virtual devices laid out on one or more named
axes (an ordered ``shape``), all living on one ``torch.device``: virtual
ranks inside one card's memory (the GPU analog of the JAX tests'
8-device virtual CPU mesh), or on the CPU for the tests. Ranks sit
row-major over the axes, as the JAX package flattens its device array:
on a ``(2, 4)`` mesh ``("x", "y")`` rank ``i*4 + j`` has coordinates
``(i, j)``. Each rank's shard is its own allocation; one kernel launch
covers all the ranks of a collective phase (``ops/ring.py``,
``ops/ici.py``).

``MeshComm`` is the counterpart of the JAX package's: a communicator
over one axis of a mesh, several, or all of them, with its collectives
and ``run``, the counterpart of its ``shard_map`` launch. Code run under
it sees every rank's shard at once, stacked on dim 0: a stacked tensor's
dim 0 is always every rank of the *mesh* (``mesh.size``), row-major over
``mesh.axis_names``, whatever axes the comm spans. A comm over a subset
of the axes acts on each group of ranks that share their other
coordinates (``ops/collectives.py``). ``P`` stands for the JAX
``PartitionSpec``: ``shard`` and ``unshard`` move a global tensor into
the stacked layout under a spec and back.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Ranks on named axes over one device: ``shape`` maps each axis
    name to its extent, in order; ``size`` is their product."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        shape = tuple(int(s) for s in shape)
        self.axis_names: Tuple[str, ...] = tuple(str(a) for a in axis_names)
        if len(shape) != len(self.axis_names) or not shape:
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if min(shape) < 1:
            raise ValueError(f"mesh extents must be >= 1, got {shape}")
        self._extents = shape
        self.size = math.prod(shape)
        self.device = torch.device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._extents))

    @property
    def devices(self) -> List[torch.device]:
        """The device each rank's shard lives on, in rank order."""
        return [self.device] * self.size

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes}, device={self.device})"


def mesh_shape_for(n: int, naxes: int = 2) -> Tuple[int, ...]:
    """Near-square factorization of ``n`` devices into ``naxes`` axes
    (own copy of the JAX package's)."""
    if naxes == 1:
        return (n,)
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    if naxes == 2:
        return best
    return (best[0],) + mesh_shape_for(best[1], naxes - 1)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("x",), device=None) -> Mesh:
    """A mesh of virtual ranks on ``device`` (a ``torch.device`` or its
    name, e.g. ``"cuda:0"`` or ``"cpu"``; ``None`` is ``cuda:0``).
    ``shape=None`` factors 8 ranks (the JAX tests' device count)
    near-square over the axes, as the JAX ``make_mesh`` factors its
    devices."""
    axis_names = tuple(axis_names)
    if shape is None:
        shape = mesh_shape_for(8, len(axis_names))
    from ..runtime.universe import resolve_device
    return Mesh(shape, axis_names, resolve_device(device))


class P(tuple):
    """A partition spec (the port's own stand-in for the JAX
    ``PartitionSpec``): one entry a tensor dim, ``None`` (not split), an
    axis name, or a tuple of names (split over their product, row-major).
    Dims past the spec's length are not split; mesh axes the spec does
    not name hold copies."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _names(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    if isinstance(part, str):
        return (part,)
    return tuple(str(a) for a in part)


def _tree_map(fn, spec, *trees):
    """``fn(spec_leaf, *leaves)`` over a dict / list / tuple tree whose
    leaves are ``P`` specs (the shape of a JAX specs pytree)."""
    if isinstance(spec, P):
        return fn(spec, *trees)
    if isinstance(spec, dict):
        return {k: _tree_map(fn, spec[k], *(t[k] for t in trees))
                for k in spec}
    if isinstance(spec, (list, tuple)):
        return type(spec)(_tree_map(fn, s, *(t[i] for t in trees))
                          for i, s in enumerate(spec))
    raise TypeError(f"not a partition spec: {spec!r}")


class MeshComm:
    """A communicator over one mesh axis, several, or all axes.

    ``axis`` is one axis name or an ordered sequence of names; the comm
    spans their product, its ranks row-major over the named axes. Its
    collectives take and return stacked tensors (dim 0 over all
    ``mesh.size`` ranks). On a multi-axis comm ``allreduce`` runs the
    per-axis ring decomposition (``ops/ici.py`` ``ici_all_reduce_mesh``:
    K4 down the axes and K5 back up at or above DEV_TIER_AXES_MIN, one
    full allreduce an axis below it); ``bcast``, ``all_gather`` and
    ``reduce_scatter`` compose per-axis phases in the JAX order (bcast
    and gather innermost-first, scatter outermost-first); ``all_to_all``,
    ``ring_shift``, ``halo_exchange``, ``scan`` and ``barrier`` use the
    first axis alone, as the JAX ``MeshComm`` does."""

    def __init__(self, mesh: Mesh, axis=None):
        self.mesh = mesh
        if axis is None:
            axis = mesh.axis_names[0]
        if isinstance(axis, (tuple, list)):
            self.axes: Tuple[str, ...] = tuple(str(a) for a in axis)
        else:
            self.axes = (str(axis),)
        for a in self.axes:
            if a not in mesh.axis_names:
                raise ValueError(f"axis {a!r} not in {mesh.axis_names}")
        if not self.axes or len(set(self.axes)) != len(self.axes):
            raise ValueError(f"bad comm axes {self.axes}")
        self.axis = self.axes[0]
        names = mesh.axis_names
        rest = [k for k, a in enumerate(names) if a not in self.axes]
        # the mesh's axes regrouped: the other axes (mesh order), then the
        # comm's (comm order); a stacked tensor viewed so is [G, size, ...]
        self._perm = rest + [names.index(a) for a in self.axes]
        self._inv = [self._perm.index(k) for k in range(len(names))]
        self._rest_sizes = [mesh._extents[k] for k in rest]

    # -- introspection ---------------------------------------------------
    @property
    def multi_axis(self) -> bool:
        return len(self.axes) > 1

    @property
    def size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def axis_sizes(self) -> Tuple[Tuple[str, int], ...]:
        """Ordered (axis, extent) pairs this comm spans."""
        return tuple((a, self.mesh.shape[a]) for a in self.axes)

    def rank(self) -> torch.Tensor:
        """Every mesh rank's rank in this comm, stacked: ``[mesh.size]``
        int64, the row-major flattened index over the comm's axes
        (``lax.axis_index`` of the axis tuple on each shard)."""
        g = self.mesh.size // self.size
        idx = torch.arange(self.size, device=self.device).expand(g, -1)
        return self.ungroup(idx)

    def _coords(self, rank: int) -> Tuple[int, ...]:
        """Per-axis coordinates of a flattened comm rank (row-major)."""
        out = []
        for a in reversed(self.axes):
            out.append(rank % self.mesh.shape[a])
            rank //= self.mesh.shape[a]
        return tuple(reversed(out))

    def sub(self, axis) -> "MeshComm":
        """A communicator over other axes of the same mesh."""
        return MeshComm(self.mesh, axis)

    # -- the stacked layout, grouped -------------------------------------
    def group(self, x: torch.Tensor) -> torch.Tensor:
        """A stacked ``[mesh.size, ...]`` tensor viewed as ``[G, size,
        ...]``: one row a group of ranks that share their coordinates on
        the other axes, the comm's ranks in order along dim 1."""
        if x.dim() < 1 or x.shape[0] != self.mesh.size:
            raise ValueError(f"expected a stacked tensor of "
                             f"{self.mesh.size} ranks on dim 0, got shape "
                             f"{tuple(x.shape)}")
        tail = tuple(x.shape[1:])
        nax = len(self._perm)
        y = x.reshape(tuple(self.mesh._extents) + tail)
        if self._perm != list(range(nax)):
            y = y.permute(self._perm + list(range(nax, y.dim())))
        return y.reshape((-1, self.size) + tail)

    def ungroup(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`group`: ``[G, size, ...]`` back to the
        stacked ``[mesh.size, ...]``."""
        tail = tuple(y.shape[2:])
        nax = len(self._perm)
        sizes = tuple(self._rest_sizes) + tuple(s for _, s in
                                                self.axis_sizes())
        y = y.reshape(sizes + tail)
        if self._perm != list(range(nax)):
            y = y.permute(self._inv + list(range(nax, y.dim())))
        return y.reshape((self.mesh.size,) + tail)

    # -- collectives -----------------------------------------------------
    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.multi_axis:
            from ..ops import ici
            rows = ici.ici_all_reduce_mesh(
                list(x.reshape(self.mesh.size, -1).unbind(0)),
                tuple(self.mesh.shape.items()), op, over=self.axes)
            return torch.stack(rows).reshape(x.shape)
        from ..ops import collectives as ops
        return ops.allreduce(x, self, op)

    def bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        from ..ops import collectives as ops
        if self.multi_axis:
            # innermost axis first: after the bcast over axis k from the
            # root's coordinate on k, the root's whole k-line holds the
            # payload, so each outer phase fans out a true copy
            for a, c in reversed(tuple(zip(self.axes,
                                           self._coords(root)))):
                x = ops.bcast(x, self.sub(a), c)
            return x
        return ops.bcast(x, self, root)

    def all_gather(self, x: torch.Tensor, tiled: bool = False,
                   gather_axis: int = 0) -> torch.Tensor:
        from ..ops import collectives as ops
        for a in reversed(self.axes):       # innermost first: rank order
            x = ops.all_gather(x, self.sub(a), tiled=tiled,
                               gather_axis=gather_axis)
        return x

    def reduce_scatter(self, x: torch.Tensor,
                       scatter_dimension: int = 0) -> torch.Tensor:
        from ..ops import collectives as ops
        for a in self.axes:                 # outermost first: rank order
            x = ops.reduce_scatter(x, self.sub(a),
                                   scatter_dimension=scatter_dimension)
        return x

    def all_to_all(self, x, split_axis: int = 0, concat_axis: int = 0):
        from ..ops import collectives as ops
        return ops.all_to_all(x, self.sub(self.axis), split_axis=split_axis,
                              concat_axis=concat_axis)

    def ring_shift(self, x, shift: int = 1):
        from ..ops import collectives as ops
        return ops.ring_shift(x, self.sub(self.axis), shift)

    def halo_exchange(self, x, halo: int, dim: int = 0,
                      periodic: bool = True):
        from ..ops import collectives as ops
        return ops.halo_exchange(x, self.sub(self.axis), halo, dim, periodic)

    def scan(self, x):
        from ..ops import collectives as ops
        return ops.scan_axis(x, self.sub(self.axis))

    def barrier(self, token=None):
        from ..ops import collectives as ops
        return ops.barrier(self.sub(self.axis))

    # -- sharding and SPMD regions ---------------------------------------
    def shard(self, x, spec: Optional[P] = None) -> torch.Tensor:
        """A global tensor (or array) in the stacked layout under
        ``spec`` (default ``P(axis)``) on the mesh's device: row r is the
        block that mesh rank r holds (the counterpart of
        ``device_put_sharded``). Mesh axes the spec does not name hold
        copies. A view of ``x`` where the layout allows it."""
        spec = P(self.axis) if spec is None else spec
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = torch.as_tensor(x, device=self.device)
        parts = tuple(spec) + (None,) * (x.dim() - len(spec))
        if len(parts) > x.dim():
            raise ValueError(f"spec {spec} is longer than shape "
                             f"{tuple(x.shape)}")
        ext = self.mesh.shape
        shape: List[int] = []
        pos: Dict[str, int] = {}
        local: List[int] = []
        for d, part in enumerate(parts):
            names = _names(part)
            k = math.prod(ext[a] for a in names)
            if any(a not in ext or a in pos for a in names) or \
                    x.shape[d] % k:
                raise ValueError(f"spec {spec} does not split shape "
                                 f"{tuple(x.shape)} over mesh {ext}")
            for a in names:
                pos[a] = len(shape)
                shape.append(ext[a])
            local.append(len(shape))
            shape.append(x.shape[d] // k)
        y = x.reshape(shape)
        for a in self.mesh.axis_names:
            if a not in pos:
                pos[a] = y.dim()
                y = y.unsqueeze(-1)
        y = y.permute([pos[a] for a in self.mesh.axis_names] + local)
        y = y.expand(tuple(self.mesh._extents)
                     + tuple(shape[i] for i in local))
        return y.reshape((self.mesh.size,) + tuple(shape[i] for i in local))

    def unshard(self, y: torch.Tensor, spec: Optional[P] = None
                ) -> torch.Tensor:
        """The inverse of :meth:`shard`: a stacked tensor back to the
        global tensor under ``spec``. A mesh axis the spec does not name
        gives its coordinate-0 copy, as ``shard_map`` with
        ``check_vma=False`` returns the first device's copy."""
        spec = P(self.axis) if spec is None else spec
        if y.dim() < 1 or y.shape[0] != self.mesh.size:
            raise ValueError(f"expected a stacked tensor of "
                             f"{self.mesh.size} ranks on dim 0, got shape "
                             f"{tuple(y.shape)}")
        tail = tuple(y.shape[1:])
        parts = tuple(spec) + (None,) * (len(tail) - len(spec))
        if len(parts) > len(tail):
            raise ValueError(f"spec {spec} is longer than the shard shape "
                             f"{tail}")
        names = self.mesh.axis_names
        y = y.reshape(tuple(self.mesh._extents) + tail)
        used = [a for part in parts for a in _names(part)]
        # the copies' coordinate 0 on every axis the spec does not name
        index = tuple(slice(None) if a in used else 0 for a in names)
        y = y[index]
        kept = [a for a in names if a in used]
        order: List[int] = []
        out: List[int] = []
        for d, part in enumerate(parts):
            for a in _names(part):
                order.append(kept.index(a))
            order.append(len(kept) + d)
            out.append(tail[d] * math.prod(self.mesh.shape[a]
                                           for a in _names(part)))
        return y.permute(order).reshape(out)

    def run(self, fn: Callable, *args, in_specs=None, out_specs=None):
        """Counterpart of the JAX ``MeshComm.run`` (``shard_map`` of
        ``fn`` over the mesh): each global argument goes into the stacked
        layout under its spec (:meth:`shard`; default ``P(axis)``),
        ``fn`` is called once on the stacked tensors, and each stacked
        result comes back as a global tensor under ``out_specs``
        (:meth:`unshard`; default ``P(axis)``). A spec tree (dict, list,
        tuple of ``P``) maps over a matching tree of tensors. ``fn``
        sees all ranks at once; it takes a comm where the JAX function
        takes an axis name (close over it)."""
        if in_specs is None:
            in_specs = tuple(P(self.axis) for _ in args)
        if out_specs is None:
            out_specs = P(self.axis)
        if len(in_specs) != len(args):
            raise ValueError(f"MeshComm.run: {len(in_specs)} in_specs for "
                             f"{len(args)} arguments")
        stacked = _tree_map(lambda s, a: self.shard(a, s), tuple(in_specs),
                            tuple(args))
        out = fn(*stacked)
        if isinstance(out_specs, P):
            if isinstance(out, (tuple, list)):
                return type(out)(self.unshard(y, out_specs) for y in out)
            return self.unshard(out, out_specs)
        return _tree_map(lambda s, y: self.unshard(y, s), out_specs, out)

    def __repr__(self):
        return (f"MeshComm(axis={self.axis!r}, size={self.size}, "
                f"mesh={self.mesh.shape})")
