"""File views: the logical data stream mapped onto physical file bytes
(a copy of the JAX package's ``io/view.py``).

A view is (disp, etype, filetype); the filetype tiles the file from
``disp`` in extent-sized tiles, and only its data bytes are visible. The
logical stream is the concatenation of every tile's data bytes.
``map_range`` flattens a logical [off, off+nbytes) window into physical
(offset, length) runs, the common currency of data sieving and two-phase
collective IO (``io/file.py``).
"""

from __future__ import annotations

from typing import List, Tuple

from ..core.datatype import BYTE, Datatype

Run = Tuple[int, int]          # (physical offset, nbytes)


class FileView:
    def __init__(self, disp: int = 0, etype: Datatype = BYTE,
                 filetype: Datatype = None):
        self.disp = disp
        self.etype = etype
        self.filetype = filetype or etype
        # flatten one filetype instance: [(off, len)] data runs in one tile
        self.spans: List[Run] = [(int(o), int(l))
                                 for o, l in self.filetype.flatten(1)]
        self.tile_data = sum(l for _, l in self.spans)   # data bytes/tile
        self.tile_extent = self.filetype.extent
        # prefix sums of span lengths for logical->span lookup
        self._prefix = []
        acc = 0
        for _, l in self.spans:
            self._prefix.append(acc)
            acc += l

    @property
    def contiguous(self) -> bool:
        return (len(self.spans) == 1 and self.spans[0][0] == 0
                and self.spans[0][1] == self.tile_extent)

    def physical(self, logical: int) -> int:
        """Physical byte offset of logical stream position ``logical``."""
        runs = self.map_range(logical, 1)
        return runs[0][0] if runs else self.disp

    def map_range(self, logical: int, nbytes: int) -> List[Run]:
        """Flatten logical [logical, logical+nbytes) into physical runs,
        in ascending file order, adjacent runs merged."""
        if nbytes <= 0:
            return []
        if self.contiguous:
            return [(self.disp + logical, nbytes)]
        out: List[Run] = []
        tile, rem = divmod(logical, self.tile_data)
        # find the span containing ``rem`` (linear scan; spans are few)
        si = 0
        while si < len(self.spans) and \
                rem >= self._prefix[si] + self.spans[si][1]:
            si += 1
        left = nbytes
        while left > 0:
            s_off, s_len = self.spans[si]
            within = rem - self._prefix[si]
            take = min(s_len - within, left)
            phys = self.disp + tile * self.tile_extent + s_off + within
            if out and out[-1][0] + out[-1][1] == phys:
                out[-1] = (out[-1][0], out[-1][1] + take)
            else:
                out.append((phys, take))
            left -= take
            rem += take
            si += 1
            if si >= len(self.spans):
                si = 0
                tile += 1
                rem = 0
        return out

    def stream_size_to(self, phys_end: int) -> int:
        """How many logical bytes precede physical offset ``phys_end``
        (used by get_position / seek with SEEK_END)."""
        if self.contiguous:
            return max(0, phys_end - self.disp)
        rel = phys_end - self.disp
        if rel <= 0:
            return 0
        tiles, within = divmod(rel, self.tile_extent)
        n = tiles * self.tile_data
        for (s_off, s_len), pre in zip(self.spans, self._prefix):
            if within <= s_off:
                break
            n += min(within - s_off, s_len)
        return n
