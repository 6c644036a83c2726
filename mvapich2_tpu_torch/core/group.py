"""Process groups (a copy of the JAX package's ``core/group.py``).

A Group is an ordered list of world ranks. All set operations from MPI-3.1
§6.3 are provided. Groups are immutable.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .errors import MPIException, MPI_ERR_GROUP, MPI_ERR_RANK, mpi_assert
from .status import UNDEFINED


class Group:
    __slots__ = ("world_ranks", "_pos")

    def __init__(self, world_ranks: Sequence[int]):
        self.world_ranks: Tuple[int, ...] = tuple(world_ranks)
        self._pos = {wr: i for i, wr in enumerate(self.world_ranks)}
        if len(self._pos) != len(self.world_ranks):
            raise MPIException(MPI_ERR_GROUP, "duplicate ranks in group")

    @property
    def size(self) -> int:
        return len(self.world_ranks)

    def rank_of_world(self, world_rank: int) -> int:
        return self._pos.get(world_rank, UNDEFINED)

    def world_of_rank(self, rank: int) -> int:
        mpi_assert(0 <= rank < self.size, MPI_ERR_RANK,
                   f"rank {rank} out of range [0,{self.size})")
        return self.world_ranks[rank]

    # -- MPI group ops ---------------------------------------------------
    def translate_ranks(self, ranks: Sequence[int], other: "Group") -> List[int]:
        """MPI_Group_translate_ranks; MPI_PROC_NULL passes through
        unchanged (MPI-3.1 §6.3.2)."""
        from .status import PROC_NULL
        return [PROC_NULL if r == PROC_NULL
                else other.rank_of_world(self.world_of_rank(r))
                for r in ranks]

    def compare(self, other: "Group") -> str:
        if self.world_ranks == other.world_ranks:
            return "ident"
        if set(self.world_ranks) == set(other.world_ranks):
            return "similar"
        return "unequal"

    def union(self, other: "Group") -> "Group":
        out = list(self.world_ranks)
        seen = set(out)
        out.extend(wr for wr in other.world_ranks if wr not in seen)
        return Group(out)

    def intersection(self, other: "Group") -> "Group":
        os_ = set(other.world_ranks)
        return Group([wr for wr in self.world_ranks if wr in os_])

    def difference(self, other: "Group") -> "Group":
        os_ = set(other.world_ranks)
        return Group([wr for wr in self.world_ranks if wr not in os_])

    def incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self.world_of_rank(r) for r in ranks])

    def excl(self, ranks: Sequence[int]) -> "Group":
        ex = set(ranks)
        for r in ex:
            mpi_assert(0 <= r < self.size, MPI_ERR_RANK, f"bad rank {r}")
        return Group([wr for i, wr in enumerate(self.world_ranks)
                      if i not in ex])

    def range_incl(self, ranges: Sequence[Tuple[int, int, int]]) -> "Group":
        ranks: List[int] = []
        for first, last, stride in ranges:
            mpi_assert(stride != 0, MPI_ERR_GROUP, "zero stride")
            r = first
            if stride > 0:
                while r <= last:
                    ranks.append(r)
                    r += stride
            else:
                while r >= last:
                    ranks.append(r)
                    r += stride
        return self.incl(ranks)

    def range_excl(self, ranges: Sequence[Tuple[int, int, int]]) -> "Group":
        inc = self.range_incl(ranges)
        ex = set(inc.world_ranks)
        return Group([wr for wr in self.world_ranks if wr not in ex])

    def __eq__(self, other) -> bool:
        return isinstance(other, Group) and \
            self.world_ranks == other.world_ranks

    def __hash__(self):
        return hash(self.world_ranks)

    def __repr__(self):
        return f"Group(size={self.size})"


GROUP_EMPTY = Group([])
GROUP_NULL = None
