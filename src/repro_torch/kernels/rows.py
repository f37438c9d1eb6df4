"""The packed row layout that the codec's kernels take.

A layout holds the rows of one dtype group of the upload codec back to
back, with no padding: leaf l contributes ``m`` rows of ``widths[l]``
values, leaf-major, so row r = l * m + i starts where row r - 1 ends and
leaf l's rows are its (m, widths[l]) block of the flat buffer. The uniform
(R, n) array is the layout of one leaf of width n with m = R.

On the device a launch reads three per-row tables, built once per (layout,
device), only read after, and kept for the process (a captured CUDA graph
reads the same buffers on every replay):

- ``start`` (R + 1,) int64: the flat offset of each row, and the total;
- ``block`` (R + 1,) int64: each row's first block in a launch that gives
  every block ``ROW_SPAN`` values of one row, and the total, so a short row
  launches few blocks and a block finds its row by a binary search;
- ``base`` (R,) int64: the dither counter of each row's first value,
  ``r * stride``, with ``stride`` the widest row. A value's counter is its
  flat index in the padded (R, stride) plane that ``jax.random.bits``
  draws, so the packed dither is JAX's padded one at the live entries.

A layout may hold a block of the clients of a larger plane: rows
``row0 .. row0 + m - 1`` of each leaf's ``m_all`` (a rank's clients on a
mesh). Its row (l, i) then takes the counters of row ``l * m_all + row0 +
i`` of the whole (L m_all, stride) plane, so each rank draws its clients'
bits of JAX's one plane.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

ROW_SPAN = 4096  # values of one row a block of a packed launch walks
MAX_BLOCKS = 2 ** 31 - 1  # gridDim.x


class RowTables(NamedTuple):
    start: torch.Tensor   # (R + 1,) int64
    block: torch.Tensor   # (R + 1,) int64
    base: torch.Tensor    # (R,) int64
    n_blocks: int


@dataclasses.dataclass(frozen=True)
class PackedRows:
    """``m`` rows of ``widths[l]`` values per leaf l, leaf-major: clients
    ``row0 .. row0 + m - 1`` of ``m_all`` (0: ``m``, the whole plane)."""

    widths: tuple[int, ...]
    m: int
    m_all: int = 0
    row0: int = 0

    def __post_init__(self):
        if self.m < 0 or any(w < 0 for w in self.widths):
            raise ValueError(f"negative rows or widths: {self}")
        if self.row0 < 0 or self.row0 + self.m > (self.m_all or self.m):
            raise ValueError(f"rows {self.row0} .. {self.row0 + self.m} of "
                             f"{self.m_all} clients: {self}")

    @property
    def rows(self) -> int:
        return len(self.widths) * self.m

    @property
    def numel(self) -> int:
        return self.m * sum(self.widths)

    @property
    def stride(self) -> int:
        """The padded plane's width: the widest row."""
        return max(self.widths, default=0)

    def leaf_offsets(self) -> list[int]:
        """Flat offset of each leaf's (m, width) block."""
        return np.concatenate(
            [[0], np.cumsum(np.asarray(self.widths, np.int64) * self.m)]
        )[:-1].tolist()

    def row_widths(self) -> np.ndarray:
        return np.repeat(np.asarray(self.widths, np.int64), self.m)

    def tables(self, device) -> RowTables:
        return _tables(self, torch.device(device))

    def counters(self, lo: int = 0, hi: int | None = None,
                 device=None) -> torch.Tensor:
        """(hi - lo,) int64: the dither counter of flat values lo..hi, each
        row's ``base`` plus the value's column."""
        hi = self.numel if hi is None else hi
        start = torch.from_numpy(_host_start(self)).to(device)
        base = torch.from_numpy(_host_base(self)).to(device)
        flat = torch.arange(lo, hi, dtype=torch.int64, device=device)
        row = torch.searchsorted(start, flat, right=True) - 1
        return base[row] + (flat - start[row])


def _host_start(rows: PackedRows) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(rows.row_widths())]).astype(
        np.int64)


def _host_base(rows: PackedRows) -> np.ndarray:
    """Each row's first counter: its row of the whole padded plane, l *
    m_all + row0 + i, times the stride."""
    r = np.arange(rows.rows, dtype=np.int64)
    if rows.m:
        r = (r // rows.m) * (rows.m_all or rows.m) + rows.row0 + r % rows.m
    return r * rows.stride


@functools.cache
def _tables(rows: PackedRows, device: torch.device) -> RowTables:
    start = _host_start(rows)
    blocks = -(-rows.row_widths() // ROW_SPAN)
    block = np.concatenate([[0], np.cumsum(blocks)]).astype(np.int64)
    if block[-1] > MAX_BLOCKS:
        raise ValueError(f"a packed launch over {rows.numel} values needs "
                         f"{block[-1]} blocks, past {MAX_BLOCKS}")
    base = _host_base(rows)
    return RowTables(*(torch.from_numpy(t).to(device)
                       for t in (start, block, base)), int(block[-1]))


def leaf_views(flat: torch.Tensor, rows: PackedRows) -> list[torch.Tensor]:
    """Each leaf's (m, width) block of a packed buffer, as a view."""
    return [flat[o:o + rows.m * w].view(rows.m, w)
            for o, w in zip(rows.leaf_offsets(), rows.widths)]


def per_leaf(rows: PackedRows, out: torch.Tensor, fn) -> torch.Tensor:
    """The plain version of a packed entry: ``fn(block, rows_of_leaf)``
    computes leaf l's (m, width) block from a view ``block(t)`` of any
    packed buffer ``t`` and the slice of the per-row operands; the result
    is written into ``out``'s view."""
    for l, (o, w) in enumerate(zip(rows.leaf_offsets(), rows.widths)):
        def block(t, o=o, w=w):
            return None if t is None else t[o:o + rows.m * w].view(rows.m, w)
        block(out).copy_(fn(block, slice(l * rows.m, (l + 1) * rows.m)))
    return out
