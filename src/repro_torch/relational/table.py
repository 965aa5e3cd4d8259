"""Column-oriented in-memory tables and catalogs.

A :class:`Table` is a named set of equal-length numpy columns.  Columns may
be integer (any width; normalized to int64), float, or string (numpy unicode
or object; normalized to numpy unicode).  GJ is a *physical* join operator:
all filters are assumed to have been applied before a table reaches it.
"""

from __future__ import annotations

import csv
import hashlib
import io
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np


def _normalize_column(values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind in ("i", "u", "b"):
        return arr.astype(np.int64)
    if arr.dtype.kind == "f":
        return arr.astype(np.float64)
    if arr.dtype.kind in ("U", "S", "O"):
        return arr.astype(np.str_)
    raise TypeError(f"unsupported column dtype {arr.dtype!r}")


@dataclass(frozen=True)
class TableDelta:
    """An append to a base table: base version -> new version + the block.

    Deltas are the unit of incremental summary maintenance (DESIGN.md §12):
    ``block`` holds only the appended rows, ``new_table`` is the full table
    after the append, and the version pair lets consumers chain deltas
    (a refresher at ``base_version`` may apply this delta; any gap means
    the chain is broken and a full rebuild is the only safe move).
    """

    table: str
    base_version: str
    new_version: str
    block: "Table"
    new_table: Optional["Table"] = None   # absent on slimmed records

    @property
    def num_rows(self) -> int:
        return self.block.num_rows

    def slim(self) -> "TableDelta":
        """This delta without the full-table reference.

        Retention-friendly: a delta log only needs the block and the
        version pair to chain refreshes; holding ``new_table`` would pin
        one full materialized copy of the grown table per logged append.
        """
        if self.new_table is None:
            return self
        return TableDelta(self.table, self.base_version, self.new_version,
                          self.block, None)


@dataclass
class Table:
    """A named columnar table."""

    name: str
    columns: Dict[str, np.ndarray]

    def __post_init__(self) -> None:
        self.columns = {k: _normalize_column(v) for k, v in self.columns.items()}
        lengths = {len(v) for v in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns in table {self.name!r}: {lengths}")

    # -- basic accessors -------------------------------------------------
    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    def __getitem__(self, col: str) -> np.ndarray:
        return self.columns[col]

    def select(self, cols: Sequence[str]) -> "Table":
        return Table(self.name, {c: self.columns[c] for c in cols})

    def take(self, idx: np.ndarray) -> "Table":
        return Table(self.name, {c: v[idx] for c, v in self.columns.items()})

    def concat(self, other: "Table") -> "Table":
        if self.column_names != other.column_names:
            raise ValueError("column mismatch in concat")
        return Table(
            self.name,
            {c: np.concatenate([self.columns[c], other.columns[c]]) for c in self.column_names},
        )

    def append(self, rows) -> TableDelta:
        """Append a row block; returns the :class:`TableDelta` describing it.

        ``rows`` is a column mapping (or another :class:`Table`) with exactly
        this table's columns and compatible dtype kinds.  The table itself is
        immutable — the delta carries the resulting ``new_table``; apply it
        through :meth:`Catalog.append` to make it visible to queries.

        The grown table's version is pre-seeded as a *chained* hash of
        (base version, block content): O(block) per append instead of a
        full-table rescan.  Still injective on content along any append
        history; the only cost is that the same content reached by a
        different construction path hashes differently — a cache miss,
        never a wrong hit.
        """
        cols = rows.columns if isinstance(rows, Table) else dict(rows)
        if set(cols) != set(self.column_names):
            raise ValueError(
                f"append block columns {sorted(cols)} != table "
                f"columns {self.column_names}")
        block = Table(self.name, {c: cols[c] for c in self.column_names})
        if block.num_rows == 0:
            # empty blocks carry no dtype information; adopt the table's
            block = Table(self.name,
                          {c: self.columns[c][:0] for c in self.column_names})
        for c in self.column_names:
            have, add = self.columns[c].dtype.kind, block.columns[c].dtype.kind
            if self.num_rows and have != add:
                raise TypeError(
                    f"append block column {c!r} has kind {add!r}, "
                    f"table has {have!r}")
        new_table = self.concat(block)
        if block.num_rows == 0:
            new_table.__dict__["_version"] = self.version()
        else:
            h = hashlib.sha256(b"delta:")
            h.update(self.version().encode())
            h.update(block.version().encode())
            new_table.__dict__["_version"] = h.hexdigest()
        return TableDelta(self.name, self.version(), new_table.version(),
                          block, new_table)

    # -- IO ----------------------------------------------------------------
    def to_csv(self, path: str) -> int:
        """Write the table as CSV; returns bytes written (paper stores CSVs)."""
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(self.column_names)
            cols = [self.columns[c] for c in self.column_names]
            for row in zip(*cols):
                writer.writerow(row)
        return os.path.getsize(path)

    @staticmethod
    def from_csv(path: str, name: Optional[str] = None) -> "Table":
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = list(reader)
        cols: Dict[str, np.ndarray] = {}
        for j, col in enumerate(header):
            raw = [r[j] for r in rows]
            try:
                cols[col] = np.asarray([int(x) for x in raw], dtype=np.int64)
            except ValueError:
                cols[col] = np.asarray(raw, dtype=np.str_)
        return Table(name or os.path.splitext(os.path.basename(path))[0], cols)

    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.columns.values()))

    def version(self) -> str:
        """Content hash of the table (schema + data).

        The compute-and-reuse cache keys summaries on (query fingerprint,
        table versions): replacing a table in the catalog — even with one of
        the same name and shape — invalidates every summary built on it.
        Computed lazily and memoized; Table treats columns as immutable after
        construction (mutate by building a new Table, as `take`/`concat` do).
        """
        cached = self.__dict__.get("_version")
        if cached is None:
            h = hashlib.sha256(self.name.encode())
            for c in sorted(self.columns):
                v = self.columns[c]
                h.update(c.encode())
                h.update(str(v.dtype).encode())
                h.update(np.ascontiguousarray(v).tobytes())
            cached = self.__dict__["_version"] = h.hexdigest()
        return cached

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Table({self.name!r}, rows={self.num_rows}, cols={self.column_names})"


@dataclass
class Catalog:
    """A named collection of tables (the 'database')."""

    tables: Dict[str, Table] = field(default_factory=dict)

    def add(self, table: Table) -> "Catalog":
        self.tables[table.name] = table
        return self

    def __getitem__(self, name: str) -> Table:
        return self.tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tables

    @staticmethod
    def of(*tables: Table) -> "Catalog":
        cat = Catalog()
        for t in tables:
            cat.add(t)
        return cat

    def names(self) -> List[str]:
        return list(self.tables.keys())

    def versions(self, names: Optional[Sequence[str]] = None) -> Dict[str, str]:
        """Content versions of the named tables (default: all)."""
        if names is None:
            names = self.names()
        return {n: self.tables[n].version() for n in names}

    def append(self, name: str, rows) -> TableDelta:
        """Append ``rows`` to table ``name`` and install the grown table.

        Returns the :class:`TableDelta`; callers holding summaries built on
        the old version hand it to the incremental refresher instead of
        recomputing from scratch.
        """
        delta = self.tables[name].append(rows)
        self.add(delta.new_table)
        return delta
