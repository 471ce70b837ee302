"""Dataset creation + IO (reference: python/ray/data/read_api.py).

Reads fan out as one task per file/partition; each task returns a block
into the object store. Formats: parquet/csv/json/text/binary/numpy via
pyarrow+pandas (both baked in; gated imports all the same).
"""

from __future__ import annotations

import builtins
import glob as _glob
import json as _json
import os
from typing import Any, Callable, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    BlockAccessor,
    BlockMetadata,
    build_output_block,
)
from ray_tpu_torch.data.dataset import Dataset

try:
    import pyarrow as pa
except Exception:  # pragma: no cover
    pa = None
try:
    import pandas as pd
except Exception:  # pragma: no cover
    pd = None


def _make_dataset(blocks: List[Any],
                  input_files: Optional[List[str]] = None) -> Dataset:
    refs, metas = [], []
    for b in blocks:
        refs.append(ray_tpu_torch.put(b))
        metas.append(BlockAccessor.for_block(b).get_metadata(input_files))
    return Dataset(refs, metas)


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    n = max(1, min(parallelism, len(items) or 1))
    per = (len(items) + n - 1) // n
    blocks = [build_output_block(items[i * per:(i + 1) * per])
              for i in builtins.range(n)]
    return _make_dataset([b for b in blocks
                          if BlockAccessor.for_block(b).num_rows() or n == 1])


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001


    per = (n + parallelism - 1) // max(parallelism, 1)
    blocks = [list(builtins.range(i, min(i + per, n)))
              for i in builtins.range(0, n, per)] or [[]]
    return _make_dataset(blocks)


def range_table(n: int, *, parallelism: int = 8) -> Dataset:


    per = (n + parallelism - 1) // max(parallelism, 1)
    blocks = []
    for i in builtins.range(0, n, per):
        vals = np.arange(i, min(i + per, n))
        blocks.append(pa.table({"value": pa.array(vals)}))
    return _make_dataset(blocks or [pa.table({"value": pa.array([])})])


def from_numpy(arrays: Union[np.ndarray, List[np.ndarray]]) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    blocks = [pa.table({"value": pa.array(list(a))}) for a in arrays]
    return _make_dataset(blocks)


def from_pandas(dfs: Union["pd.DataFrame", List["pd.DataFrame"]]) -> Dataset:
    if pd is not None and isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    blocks = [pa.Table.from_pandas(df, preserve_index=False) for df in dfs]
    return _make_dataset(blocks)


def from_arrow(tables: Union["pa.Table", List["pa.Table"]]) -> Dataset:
    if pa is not None and isinstance(tables, pa.Table):
        tables = [tables]
    return _make_dataset(list(tables))


def _expand_paths(paths: Union[str, List[str]]) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    return out


def _read_files(paths, read_one: Callable[[str], Any]) -> Dataset:
    files = _expand_paths(paths)
    if not files:
        raise FileNotFoundError(f"no input files at {paths}")

    @ray_tpu_torch.remote(num_returns=2)
    def _read(path: str):
        block = read_one(path)
        return block, BlockAccessor.for_block(block).get_metadata([path])

    refs, meta_refs = [], []
    for f in files:
        b, m = _read.remote(f)
        refs.append(b)
        meta_refs.append(m)
    return Dataset(refs, ray_tpu_torch.get(meta_refs))


def read_parquet(paths, **kwargs) -> Dataset:
    import pyarrow.parquet as pq

    return _read_files(paths, lambda p: pq.read_table(p, **kwargs))


def read_csv(paths, **kwargs) -> Dataset:
    from pyarrow import csv as pa_csv

    return _read_files(paths, lambda p: pa_csv.read_csv(p, **kwargs))


def read_json(paths, **kwargs) -> Dataset:
    def _read_one(p: str):
        rows = []
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(_json.loads(line))
        return build_output_block(rows)

    return _read_files(paths, _read_one)


def read_text(paths, *, encoding: str = "utf-8") -> Dataset:
    def _read_one(p: str):
        with open(p, encoding=encoding) as f:
            return [ln.rstrip("\n") for ln in f]

    return _read_files(paths, _read_one)


def read_binary_files(paths) -> Dataset:
    def _read_one(p: str):
        with open(p, "rb") as f:
            return [f.read()]

    return _read_files(paths, _read_one)


def read_numpy(paths) -> Dataset:
    def _read_one(p: str):
        arr = np.load(p)
        return pa.table({"value": pa.array(list(arr))})

    return _read_files(paths, _read_one)


# --------------------------------------------------------------------- write
def _write_blocks(block_refs, path: str, fmt: str) -> None:
    os.makedirs(path, exist_ok=True)

    @ray_tpu_torch.remote
    def _write(block, out_path: str):
        acc = BlockAccessor.for_block(block)
        if fmt == "parquet":
            import pyarrow.parquet as pq

            pq.write_table(acc.to_arrow(), out_path)
        elif fmt == "csv":
            acc.to_pandas().to_csv(out_path, index=False)
        elif fmt == "json":
            with open(out_path, "w") as f:
                for row in acc.iter_rows():
                    f.write(_json.dumps(_jsonable(row)) + "\n")
        return out_path

    ext = {"parquet": "parquet", "csv": "csv", "json": "json"}[fmt]
    ray_tpu_torch.get([
        _write.remote(ref, os.path.join(path, f"part-{i:05d}.{ext}"))
        for i, ref in enumerate(block_refs)])


def _jsonable(row: Any) -> Any:
    if isinstance(row, dict):
        return {k: _jsonable(v) for k, v in row.items()}
    if isinstance(row, (np.integer,)):
        return int(row)
    if isinstance(row, (np.floating,)):
        return float(row)
    if isinstance(row, np.ndarray):
        return row.tolist()
    return row
