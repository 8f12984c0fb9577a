"""Versioned quadtree cell geometry (doc/partitioning.md).

The spatial grid's cell layout is no longer a boot-time constant: the
adaptive partitioning plane (spatial/partition.py) splits hot cells into
four children and merges cold sibling groups back, and every consumer of
cell geometry — channel-id math, adjacency, server placement, the device
mirror — consults the live :class:`CellTree` instead of hard-coding the
base-grid formula.

Geometry state is just ``(epoch, splits)``: a monotonic epoch counter
plus the set of cell ids that are split (interior nodes). An empty split
set reproduces the legacy static grid bit-for-bit — every depth-0 id,
adjacency set and server index is identical to the fixed-grid formulas
the geometry tests pin.

Cell-id arithmetic is closed-form so every gateway derives the SAME ids
with no allocation coordination: depth-``d`` cells occupy a contiguous
block above the base grid,

    block_base(d) = start + base_count * (4**d - 1) // 3
    id(d, gx, gz) = block_base(d) + gz * (cols << d) + gx

with ``base_count = cols * rows``. Depth 0 degenerates to the legacy
``start + gx + gz*cols``. The id space consumed by ``max_depth`` levels
must fit under ``entity_channel_id_start`` — validated at load.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..utils.logger import get_logger

logger = get_logger("spatial.celltree")


class CellTree:
    """Quadtree over the base grid; identity + geometry math.

    Immutable-by-convention: mutation happens through :meth:`apply`,
    which replaces ``(epoch, splits)`` wholesale (the form WAL replay,
    trunk sync and the partition plane all share). Planning helpers
    (:meth:`split_result` / :meth:`merge_result`) return the candidate
    split set without touching live state.
    """

    def __init__(self, start: int, cols: int, rows: int,
                 cell_w: float, cell_h: float,
                 offset_x: float, offset_z: float,
                 max_depth: int = 0) -> None:
        self.start = start
        self.cols = cols
        self.rows = rows
        self.cell_w = cell_w
        self.cell_h = cell_h
        self.offset_x = offset_x
        self.offset_z = offset_z
        self.max_depth = max_depth
        self.epoch = 0
        self.splits: frozenset[int] = frozenset()

    # ---- closed-form id arithmetic -----------------------------------

    @property
    def base_count(self) -> int:
        return self.cols * self.rows

    def block_base(self, depth: int) -> int:
        """First cell id of the depth-``depth`` block."""
        return self.start + self.base_count * ((4 ** depth) - 1) // 3

    def id_space_end(self) -> int:
        """One past the last id ``max_depth`` levels can ever use."""
        return self.block_base(self.max_depth + 1)

    def encode(self, depth: int, gx: int, gz: int) -> int:
        return self.block_base(depth) + gz * (self.cols << depth) + gx

    def decode(self, cell_id: int) -> tuple[int, int, int]:
        """cell id -> (depth, gx, gz); raises on out-of-space ids."""
        d = 0
        while cell_id >= self.block_base(d + 1):
            d += 1
            if d > self.max_depth + 1:
                raise ValueError(f"cell id {cell_id} beyond depth bound")
        idx = cell_id - self.block_base(d)
        w = self.cols << d
        return d, idx % w, idx // w

    def depth_of(self, cell_id: int) -> int:
        return self.decode(cell_id)[0]

    def parent(self, cell_id: int) -> Optional[int]:
        d, gx, gz = self.decode(cell_id)
        if d == 0:
            return None
        return self.encode(d - 1, gx >> 1, gz >> 1)

    def children(self, cell_id: int) -> list[int]:
        """The four depth+1 children, row-major (z then x)."""
        d, gx, gz = self.decode(cell_id)
        return [self.encode(d + 1, (gx << 1) + dx, (gz << 1) + dz)
                for dz in (0, 1) for dx in (0, 1)]

    def sibling_group(self, cell_id: int) -> list[int]:
        p = self.parent(cell_id)
        if p is None:
            return [cell_id]
        return self.children(p)

    def base_cell_of(self, cell_id: int) -> int:
        """Base-grid (depth-0) index containing this cell."""
        d, gx, gz = self.decode(cell_id)
        return (gx >> d) + (gz >> d) * self.cols

    # ---- tree membership ---------------------------------------------

    def exists(self, cell_id: int) -> bool:
        try:
            d, _, _ = self.decode(cell_id)
        except ValueError:
            return False
        if d == 0:
            return True
        p = self.parent(cell_id)
        return p is not None and p in self.splits and self.exists(p)

    def is_leaf(self, cell_id: int) -> bool:
        return self.exists(cell_id) and cell_id not in self.splits

    def leaves_under(self, cell_id: int) -> list[int]:
        """All leaf cells at or beneath ``cell_id`` (itself if leaf)."""
        if cell_id not in self.splits:
            return [cell_id]
        out: list[int] = []
        for c in self.children(cell_id):
            out.extend(self.leaves_under(c))
        return out

    def leaves(self) -> list[int]:
        """Every live leaf, base-grid order then depth-first."""
        out: list[int] = []
        for base in range(self.start, self.start + self.base_count):
            out.extend(self.leaves_under(base))
        return out

    def max_active_depth(self) -> int:
        d = 0
        for s in self.splits:
            d = max(d, self.depth_of(s) + 1)
        return d

    # ---- world-space geometry ----------------------------------------

    def rect(self, cell_id: int) -> tuple[float, float, float, float]:
        """(x0, z0, x1, z1) world-space bounds of the cell."""
        d, gx, gz = self.decode(cell_id)
        w = self.cell_w / (1 << d)
        h = self.cell_h / (1 << d)
        x0 = self.offset_x + gx * w
        z0 = self.offset_z + gz * h
        return x0, z0, x0 + w, z0 + h

    def center(self, cell_id: int) -> tuple[float, float]:
        x0, z0, x1, z1 = self.rect(cell_id)
        return (x0 + x1) / 2.0, (z0 + z1) / 2.0

    def leaf_at(self, x: float, z: float) -> Optional[int]:
        """Leaf cell containing world position (x, z); None if outside."""
        gx = int((x - self.offset_x) // self.cell_w)
        gz = int((z - self.offset_z) // self.cell_h)
        if not (0 <= gx < self.cols and 0 <= gz < self.rows):
            return None
        cell = self.encode(0, gx, gz)
        d = 0
        while cell in self.splits:
            d += 1
            w = self.cell_w / (1 << d)
            h = self.cell_h / (1 << d)
            gx = int((x - self.offset_x) // w)
            gz = int((z - self.offset_z) // h)
            # Clamp against float edge cases at the far border.
            gx = min(gx, (self.cols << d) - 1)
            gz = min(gz, (self.rows << d) - 1)
            cell = self.encode(d, gx, gz)
        return cell

    def leaves_in_rect(self, x0: float, z0: float,
                       x1: float, z1: float) -> list[int]:
        """Leaves whose rect intersects [x0,x1) x [z0,z1)."""
        eps = 1e-9
        bx0 = max(0, int((x0 - self.offset_x) // self.cell_w))
        bz0 = max(0, int((z0 - self.offset_z) // self.cell_h))
        bx1 = min(self.cols - 1,
                  int((x1 - eps - self.offset_x) // self.cell_w))
        bz1 = min(self.rows - 1,
                  int((z1 - eps - self.offset_z) // self.cell_h))
        out: list[int] = []
        for gz in range(bz0, bz1 + 1):
            for gx in range(bx0, bx1 + 1):
                for leaf in self.leaves_under(self.encode(0, gx, gz)):
                    lx0, lz0, lx1, lz1 = self.rect(leaf)
                    if lx0 < x1 and lx1 > x0 and lz0 < z1 and lz1 > z0:
                        out.append(leaf)
        return out

    def neighbor_leaves(self, cell_id: int) -> list[int]:
        """Leaves within one BASE cell of ``cell_id`` (excl. itself).

        With no splits this is exactly the legacy 3x3 neighborhood;
        with splits it is every leaf intersecting the same border band.
        """
        x0, z0, x1, z1 = self.rect(cell_id)
        out = self.leaves_in_rect(x0 - self.cell_w, z0 - self.cell_h,
                                  x1 + self.cell_w, z1 + self.cell_h)
        return [c for c in out if c != cell_id]

    def server_index_of(self, cell_id: int, sgc: int, sgr: int,
                        server_cols: int) -> int:
        """Owning server index — children inherit the base cell's."""
        base = self.base_cell_of(cell_id)
        gx, gz = base % self.cols, base // self.cols
        return (gx // sgc) + (gz // sgr) * server_cols

    # ---- uniform micro grid (device mirror) --------------------------

    def micro_spec(self) -> tuple[int, int, int, float, float]:
        """(depth, micro_cols, micro_rows, micro_w, micro_h).

        The finest uniform grid that resolves every live leaf: the
        device engine runs on this grid and the host maps micro cells
        back to leaf channel ids via :meth:`micro_to_leaf`.
        """
        d = self.max_active_depth()
        return (d, self.cols << d, self.rows << d,
                self.cell_w / (1 << d), self.cell_h / (1 << d))

    def micro_to_leaf(self) -> list[int]:
        """Row-major micro-cell index -> leaf channel id."""
        d, mcols, mrows, _, _ = self.micro_spec()
        out = [0] * (mcols * mrows)
        for leaf in self.leaves():
            ld, gx, gz = self.decode(leaf)
            span = 1 << (d - ld)
            for dz in range(span):
                row = (gz * span + dz) * mcols
                for dx in range(span):
                    out[row + gx * span + dx] = leaf
        return out

    # ---- mutation ----------------------------------------------------

    def validate_splits(self, splits: Iterable[int]) -> Optional[str]:
        """None if ``splits`` forms a well-formed tree, else a reason."""
        s = frozenset(splits)
        for cell in s:
            try:
                d, gx, gz = self.decode(cell)
            except ValueError:
                return f"cell {cell} outside the id space"
            if d >= self.max_depth:
                return f"cell {cell} split past max depth {self.max_depth}"
            if not (0 <= gx < (self.cols << d)
                    and 0 <= gz < (self.rows << d)):
                return f"cell {cell} outside the grid"
            if d > 0:
                p = self.encode(d - 1, gx >> 1, gz >> 1)
                if p not in s:
                    return f"cell {cell} split but parent {p} is not"
        return None

    def apply(self, epoch: int, splits: Iterable[int]) -> None:
        """Replace geometry wholesale (partition commit / sync / replay)."""
        err = self.validate_splits(splits)
        if err is not None:
            raise ValueError(f"invalid geometry at epoch {epoch}: {err}")
        self.epoch = epoch
        self.splits = frozenset(splits)

    def split_result(self, cell_id: int) -> frozenset[int]:
        """Split set after splitting leaf ``cell_id`` (validated)."""
        if not self.is_leaf(cell_id):
            raise ValueError(f"cell {cell_id} is not a live leaf")
        if self.depth_of(cell_id) >= self.max_depth:
            raise ValueError(f"cell {cell_id} at max depth")
        return self.splits | {cell_id}

    def merge_result(self, parent_id: int) -> frozenset[int]:
        """Split set after merging ``parent_id``'s children back."""
        if parent_id not in self.splits:
            raise ValueError(f"cell {parent_id} is not split")
        for c in self.children(parent_id):
            if c in self.splits:
                raise ValueError(
                    f"child {c} of {parent_id} is itself split")
        return self.splits - {parent_id}
