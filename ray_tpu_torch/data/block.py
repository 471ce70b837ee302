"""Blocks — the unit of distributed data.

A Dataset is a list of ObjectRefs to *blocks* (reference:
python/ray/data/impl/block_list.py, arrow_block.py, simple_block.py).
Two physical layouts:

  - **list blocks**: plain Python lists of rows (the reference's
    SimpleBlock) — universal fallback.
  - **table blocks**: pyarrow.Table (the reference's ArrowBlock) — used
    for structured data; zero-copy to numpy columns, which is the path
    that feeds ``Dataset.to_device`` for training on the card.

``BlockAccessor.for_block`` dispatches on the physical type, exactly like
the reference's ``BlockAccessor.for_block`` (python/ray/data/block.py).
"""

from __future__ import annotations

import random
import sys
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Tuple, Union

import numpy as np

try:  # gated: table blocks need pyarrow
    import pyarrow as pa
except Exception:  # pragma: no cover
    pa = None

try:
    import pandas as pd
except Exception:  # pragma: no cover
    pd = None

Block = Union[list, "pa.Table"]


@dataclass
class BlockMetadata:
    """Sidecar stats carried next to every block ref (reference:
    python/ray/data/block.py BlockMetadata)."""
    num_rows: Optional[int]
    size_bytes: Optional[int]
    schema: Optional[Any] = None
    input_files: Optional[List[str]] = None
    # node that produced the block (reference: block locations feed
    # dataset.py:735's locality-aware split); None = location unknown
    node_id: Optional[str] = None


class BlockAccessor:
    """Uniform view over a physical block."""

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        if pa is not None and isinstance(block, pa.Table):
            return ArrowBlockAccessor(block)
        if pd is not None and isinstance(block, pd.DataFrame):
            return ArrowBlockAccessor(pa.Table.from_pandas(block))
        if isinstance(block, (list, tuple)):
            return SimpleBlockAccessor(list(block))
        if isinstance(block, np.ndarray):
            return ArrowBlockAccessor(
                pa.table({"value": pa.array(list(block))}))
        raise TypeError(f"not a block type: {type(block)}")

    @staticmethod
    def builder_for(block: Block) -> "BlockBuilder":
        if pa is not None and isinstance(block, pa.Table):
            return ArrowBlockBuilder()
        return SimpleBlockBuilder()

    # --- interface -------------------------------------------------------
    def num_rows(self) -> int:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def iter_rows(self) -> Iterator[Any]:
        raise NotImplementedError

    def slice(self, start: int, end: int) -> Block:
        raise NotImplementedError

    def take(self, indices: List[int]) -> Block:
        raise NotImplementedError

    def to_pandas(self):
        raise NotImplementedError

    def to_numpy(self, column: Optional[str] = None):
        raise NotImplementedError

    def to_arrow(self):
        raise NotImplementedError

    def to_batch(self, batch_format: str):
        """Materialize in the caller-requested format ('native', 'pandas',
        'pyarrow', 'numpy')."""
        if batch_format in ("native", "default"):
            return self.to_native()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "pyarrow":
            return self.to_arrow()
        if batch_format == "numpy":
            return self.to_numpy()
        raise ValueError(f"unknown batch_format: {batch_format}")

    def to_native(self) -> Block:
        raise NotImplementedError

    def schema(self) -> Any:
        raise NotImplementedError

    def sample(self, n: int, key: Optional[Callable] = None) -> List[Any]:
        rows = list(self.iter_rows())
        if not rows:
            return []
        picks = random.sample(rows, min(n, len(rows)))
        return [key(r) if key else r for r in picks]

    def get_metadata(self, input_files: Optional[List[str]] = None
                     ) -> BlockMetadata:
        return BlockMetadata(self.num_rows(), self.size_bytes(),
                             self.schema(), input_files)


# =========================================================================
class SimpleBlockAccessor(BlockAccessor):
    def __init__(self, block: list):
        self._block = block

    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        return sum(sys.getsizeof(r) for r in self._block)

    def iter_rows(self) -> Iterator[Any]:
        return iter(self._block)

    def slice(self, start: int, end: int) -> Block:
        return self._block[start:end]

    def take(self, indices: List[int]) -> Block:
        return [self._block[i] for i in indices]

    def to_pandas(self):
        return pd.DataFrame({"value": self._block})

    def to_numpy(self, column: Optional[str] = None):
        return np.array(self._block)

    def to_arrow(self):
        return pa.table({"value": pa.array(self._block)})

    def to_native(self) -> Block:
        return self._block

    def schema(self) -> Any:
        return type(self._block[0]) if self._block else None


class ArrowBlockAccessor(BlockAccessor):
    def __init__(self, table: "pa.Table"):
        self._table = table

    def num_rows(self) -> int:
        return self._table.num_rows

    def size_bytes(self) -> int:
        return self._table.nbytes

    def iter_rows(self) -> Iterator[dict]:
        for batch in self._table.to_batches():
            cols = {name: batch.column(i)
                    for i, name in enumerate(batch.schema.names)}
            for i in range(batch.num_rows):
                yield {n: c[i].as_py() for n, c in cols.items()}

    def slice(self, start: int, end: int) -> Block:
        return self._table.slice(start, end - start)

    def take(self, indices: List[int]) -> Block:
        return self._table.take(pa.array(indices, type=pa.int64()))

    def to_pandas(self):
        return self._table.to_pandas()

    def to_numpy(self, column: Optional[str] = None):
        if column is not None:
            return self._table.column(column).to_numpy(zero_copy_only=False)
        return {n: self._table.column(n).to_numpy(zero_copy_only=False)
                for n in self._table.schema.names}

    def to_arrow(self):
        return self._table

    def to_native(self) -> Block:
        return self._table

    def schema(self) -> Any:
        return self._table.schema


# =========================================================================
class BlockBuilder:
    def add(self, row: Any) -> None:
        raise NotImplementedError

    def add_block(self, block: Block) -> None:
        raise NotImplementedError

    def num_rows(self) -> int:
        raise NotImplementedError

    def build(self) -> Block:
        raise NotImplementedError


class SimpleBlockBuilder(BlockBuilder):
    def __init__(self):
        self._rows: list = []

    def add(self, row: Any) -> None:
        self._rows.append(row)

    def add_block(self, block: Block) -> None:
        self._rows.extend(BlockAccessor.for_block(block).iter_rows())

    def num_rows(self) -> int:
        return len(self._rows)

    def build(self) -> Block:
        return self._rows


class ArrowBlockBuilder(BlockBuilder):
    def __init__(self):
        self._tables: List["pa.Table"] = []
        self._rows: List[dict] = []

    def add(self, row: Any) -> None:
        if not isinstance(row, dict):
            row = {"value": row}
        self._rows.append(row)

    def add_block(self, block: Block) -> None:
        if pa is not None and isinstance(block, pa.Table):
            self._tables.append(block)
        else:
            for r in BlockAccessor.for_block(block).iter_rows():
                self.add(r)

    def num_rows(self) -> int:
        return (sum(t.num_rows for t in self._tables) + len(self._rows))

    def build(self) -> Block:
        tables = list(self._tables)
        if self._rows:
            cols = {k: [r.get(k) for r in self._rows]
                    for k in self._rows[0].keys()}
            tables.append(pa.table(cols))
        if not tables:
            return pa.table({})
        if len(tables) == 1:
            return tables[0]
        return pa.concat_tables(tables, promote_options="default")


def build_output_block(rows: List[Any]) -> Block:
    """Pick the physical layout from the row type, like the reference's
    DelegatingArrowBlockBuilder (python/ray/data/impl/arrow_block.py)."""
    if rows and isinstance(rows[0], dict) and pa is not None:
        b = ArrowBlockBuilder()
        for r in rows:
            b.add(r)
        return b.build()
    return list(rows)


def batch_to_block(batch: Any) -> Block:
    """Normalize a user map_batches return value to a block."""
    if pa is not None and isinstance(batch, pa.Table):
        return batch
    if pd is not None and isinstance(batch, pd.DataFrame):
        return pa.Table.from_pandas(batch, preserve_index=False)
    if isinstance(batch, np.ndarray):
        return pa.table({"value": pa.array(list(batch))})
    if isinstance(batch, dict):
        return pa.table({k: pa.array(np.asarray(v)) for k, v in batch.items()})
    if isinstance(batch, list):
        return build_output_block(batch)
    raise TypeError(f"cannot convert batch of type {type(batch)} to a block")
