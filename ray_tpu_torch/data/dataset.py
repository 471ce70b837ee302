"""Dataset — distributed data as a list of block ObjectRefs.

Reference: python/ray/data/dataset.py:90. Every transform ships a
block-level function to stateless tasks (or an actor pool), producing a
new Dataset; nothing is materialized in the caller until take()/to_*.

Additions over the reference surface:
  - ``iter_batches(batch_format="numpy")`` feeds zero-copy numpy columns,
  - ``to_device(...)`` yields batches on the card for a train step: the
    counterpart of the JAX package's ``to_jax``, with its dtypes.
"""

from __future__ import annotations

import itertools
import math
import random
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    BlockMetadata,
    batch_to_block,
    build_output_block,
)
from ray_tpu_torch.data.compute import get_compute
from ray_tpu_torch.data.stats import DatasetStats


class Dataset:
    def __init__(self, block_refs: List["ray_tpu_torch.ObjectRef"],
                 metadata: Optional[List[BlockMetadata]] = None,
                 stats: Optional[DatasetStats] = None):
        self._blocks = list(block_refs)
        self._metadata = list(metadata) if metadata is not None else [
            None] * len(self._blocks)
        self._stats = stats or DatasetStats()

    # ------------------------------------------------------------ plumbing
    def _ensure_metadata(self) -> List[BlockMetadata]:
        missing = [i for i, m in enumerate(self._metadata) if m is None]
        if missing:
            blocks = ray_tpu_torch.get([self._blocks[i] for i in missing])
            for i, b in zip(missing, blocks):
                self._metadata[i] = BlockAccessor.for_block(b).get_metadata()
        return self._metadata

    def get_internal_block_refs(self) -> List["ray_tpu_torch.ObjectRef"]:
        return list(self._blocks)

    def num_blocks(self) -> int:
        return len(self._blocks)

    def size_bytes(self) -> Optional[int]:
        metas = self._ensure_metadata()
        sizes = [m.size_bytes for m in metas if m and m.size_bytes is not None]
        return sum(sizes) if sizes else None

    def schema(self) -> Any:
        for m in self._metadata:
            if m is not None and m.schema is not None:
                return m.schema
        if not self._blocks:
            return None
        block = ray_tpu_torch.get([self._blocks[0]])[0]
        return BlockAccessor.for_block(block).schema()

    def stats(self) -> str:
        return self._stats.summary()

    def _map_block_fn(self, name: str, fn: Callable[[Block], Block],
                      compute=None, **remote_args) -> "Dataset":
        t0 = time.perf_counter()
        strategy = get_compute(compute)
        refs, metas = strategy.apply(fn, remote_args, self._blocks)
        stats = self._stats.child(name, time.perf_counter() - t0, metas)
        return Dataset(refs, metas, stats)

    # ---------------------------------------------------------- transforms
    def map(self, fn: Callable[[Any], Any], *, compute=None,
            **remote_args) -> "Dataset":
        def _map(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            return build_output_block([fn(r) for r in acc.iter_rows()])
        return self._map_block_fn("map", _map, compute, **remote_args)

    def flat_map(self, fn: Callable[[Any], List[Any]], *, compute=None,
                 **remote_args) -> "Dataset":
        def _fmap(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            out: List[Any] = []
            for r in acc.iter_rows():
                out.extend(fn(r))
            return build_output_block(out)
        return self._map_block_fn("flat_map", _fmap, compute, **remote_args)

    def filter(self, fn: Callable[[Any], bool], *, compute=None,
               **remote_args) -> "Dataset":
        def _filter(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            rows = [r for r in acc.iter_rows() if fn(r)]
            if not rows:
                builder = BlockAccessor.builder_for(block)
                return builder.build()
            return build_output_block(rows)
        return self._map_block_fn("filter", _filter, compute, **remote_args)

    # -- column ops (reference: data/dataset.py add_column /
    # drop_columns / select_columns over pandas batches) ---------------
    @staticmethod
    def _column_op_frame(block: Block):
        """Block -> DataFrame for the column ops, or None for empty
        SCHEMALESS blocks (an emptied list block, or the zero-column
        Arrow table `pa.table({})` that filter() builds, has no columns
        to transform; an empty Arrow block WITH a schema still goes
        through the op so schema() stays consistent)."""
        acc = BlockAccessor.for_block(block)
        if acc.num_rows() == 0:
            if isinstance(block, list):
                return None
            df = acc.to_pandas()
            return None if df.shape[1] == 0 else df
        return acc.to_pandas()

    def add_column(self, col: str, fn: Callable[[Any], Any], *,
                   compute=None, **remote_args) -> "Dataset":
        """fn receives each block as a pandas DataFrame and returns the
        new column's values."""
        from ray_tpu_torch.data.block import batch_to_block

        def _add(block: Block) -> Block:
            df = self._column_op_frame(block)
            if df is None:
                return block
            df[col] = fn(df)
            return batch_to_block(df)
        return self._map_block_fn("add_column", _add, compute,
                                  **remote_args)

    def drop_columns(self, cols: List[str], *, compute=None,
                     **remote_args) -> "Dataset":
        from ray_tpu_torch.data.block import batch_to_block

        def _drop(block: Block) -> Block:
            df = self._column_op_frame(block)
            if df is None:
                return block
            return batch_to_block(df.drop(columns=list(cols)))
        return self._map_block_fn("drop_columns", _drop, compute,
                                  **remote_args)

    def select_columns(self, cols: List[str], *, compute=None,
                       **remote_args) -> "Dataset":
        from ray_tpu_torch.data.block import batch_to_block

        def _select(block: Block) -> Block:
            df = self._column_op_frame(block)
            if df is None:
                return block
            return batch_to_block(df[list(cols)])
        return self._map_block_fn("select_columns", _select, compute,
                                  **remote_args)

    def map_batches(self, fn: Callable[[Any], Any], *,
                    batch_size: Optional[int] = None,
                    batch_format: str = "native", compute=None,
                    **remote_args) -> "Dataset":
        def _map_batches(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            size = batch_size or max(n, 1)
            outs = []
            for start in range(0, max(n, 1), size):
                if n == 0:
                    break
                sub = BlockAccessor.for_block(
                    acc.slice(start, min(start + size, n)))
                result = fn(sub.to_batch(batch_format))
                outs.append(batch_to_block(result))
            if not outs:
                return block
            builder = BlockAccessor.builder_for(outs[0])
            for o in outs:
                builder.add_block(o)
            return builder.build()
        return self._map_block_fn("map_batches", _map_batches, compute,
                                  **remote_args)

    # -------------------------------------------------------- restructure
    def repartition(self, num_blocks: int, *, shuffle: bool = False
                    ) -> "Dataset":
        if shuffle:
            from ray_tpu_torch.data.shuffle import shuffle_blocks
            refs, metas = shuffle_blocks(self._blocks, num_blocks,
                                         randomize=False)
            return Dataset(refs, metas,
                           self._stats.child("repartition", 0.0, metas))
        total = self.count()
        per = math.ceil(total / max(num_blocks, 1)) if total else 0

        rows_iter = self.iter_rows()
        blocks: List[Block] = []
        for _ in range(num_blocks):
            chunk = list(itertools.islice(rows_iter, per)) if per else []
            blocks.append(build_output_block(chunk))
        refs = [ray_tpu_torch.put(b) for b in blocks]
        metas = [BlockAccessor.for_block(b).get_metadata() for b in blocks]
        return Dataset(refs, metas,
                       self._stats.child("repartition", 0.0, metas))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        from ray_tpu_torch.data.shuffle import shuffle_blocks
        t0 = time.perf_counter()
        refs, metas = shuffle_blocks(
            self._blocks, num_blocks or len(self._blocks) or 1,
            randomize=True, seed=seed)
        return Dataset(refs, metas, self._stats.child(
            "random_shuffle", time.perf_counter() - t0, metas))

    def sort(self, key: Optional[Union[str, Callable]] = None,
             descending: bool = False) -> "Dataset":
        from ray_tpu_torch.data.sort import sort_blocks
        t0 = time.perf_counter()
        refs, metas = sort_blocks(self._blocks, key, descending)
        return Dataset(refs, metas, self._stats.child(
            "sort", time.perf_counter() - t0, metas))

    def groupby(self, key: Optional[Union[str, Callable]]) -> "GroupedDataset":
        from ray_tpu_torch.data.grouped import GroupedDataset
        return GroupedDataset(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        rows_a = list(self.iter_rows())
        rows_b = list(other.iter_rows())
        if len(rows_a) != len(rows_b):
            raise ValueError("zip requires datasets of equal length")
        out = []
        for a, b in zip(rows_a, rows_b):
            if isinstance(a, dict) and isinstance(b, dict):
                merged = dict(a)
                for k, v in b.items():
                    merged[k if k not in merged else f"{k}_1"] = v
                out.append(merged)
            else:
                out.append((a, b))
        block = build_output_block(out)
        meta = BlockAccessor.for_block(block).get_metadata()
        return Dataset([ray_tpu_torch.put(block)], [meta],
                       self._stats.child("zip", 0.0, [meta]))

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._blocks)
        metas = list(self._metadata)
        for o in others:
            refs.extend(o._blocks)
            metas.extend(o._metadata)
        return Dataset(refs, metas, self._stats.child("union", 0.0, []))

    def limit(self, limit: int) -> "Dataset":
        metas = self._ensure_metadata()
        refs, out_metas, taken = [], [], 0
        for ref, meta in zip(self._blocks, metas):
            if taken >= limit:
                break
            n = meta.num_rows or 0
            if taken + n <= limit:
                refs.append(ref)
                out_metas.append(meta)
                taken += n
            else:
                block = ray_tpu_torch.get([ref])[0]
                acc = BlockAccessor.for_block(block)
                cut = acc.slice(0, limit - taken)
                refs.append(ray_tpu_torch.put(cut))
                out_metas.append(BlockAccessor.for_block(cut).get_metadata())
                taken = limit
        return Dataset(refs, out_metas, self._stats.child("limit", 0.0,
                                                          out_metas))

    def split(self, n: int, *, equal: bool = False,
              locality_hints: Optional[List[Any]] = None
              ) -> List["Dataset"]:
        """Split into n sub-datasets by whole blocks (reference:
        dataset.py:514). With ``locality_hints`` (one actor handle per
        output split), blocks are assigned to the split whose actor
        lives on the block's producing node (block metadata carries
        node_id), balanced so no split exceeds ceil(blocks/n) —
        reference dataset.py:735's locality-aware assignment."""
        if n <= 0:
            raise ValueError("n must be positive")
        if equal and locality_hints is not None:
            raise ValueError(
                "equal=True re-chunks rows into fresh driver-side "
                "blocks, so locality_hints cannot be honored; pass one "
                "or the other (reference rejects the combination too)")
        if equal:
            total = self.count()
            per = total // n
            rows_iter = self.iter_rows()
            out = []
            for i in range(n):
                chunk = list(itertools.islice(rows_iter, per))
                block = build_output_block(chunk)
                meta = BlockAccessor.for_block(block).get_metadata()
                out.append(Dataset([ray_tpu_torch.put(block)], [meta]))
            return out
        metas = self._ensure_metadata()
        shards: List[Tuple[List, List]] = [([], []) for _ in range(n)]
        if locality_hints is not None:
            if len(locality_hints) != n:
                raise ValueError(
                    f"len(locality_hints)={len(locality_hints)} != n={n}")
            return self._split_with_locality(n, metas, locality_hints)
        for i, (ref, meta) in enumerate(zip(self._blocks, metas)):
            shards[i % n][0].append(ref)
            shards[i % n][1].append(meta)
        return [Dataset(refs, ms) for refs, ms in shards]

    def _split_with_locality(self, n: int, metas,
                             locality_hints: List[Any]) -> List["Dataset"]:
        """Greedy locality assignment: each block goes to a split whose
        hint actor sits on the block's producing node if one still has
        room (cap ceil(blocks/n), so locality never unbalances the
        shards); leftovers fill the emptiest splits."""
        import math as _math

        hint_nodes = []
        for hint in locality_hints:
            try:
                from ray_tpu_torch.gcs.state import actor_node_of

                node = actor_node_of(hint)
            except Exception:
                node = None
            hint_nodes.append(node)
        cap = _math.ceil(len(self._blocks) / n)
        shards: List[Tuple[List, List]] = [([], []) for _ in range(n)]
        leftovers = []
        for ref, meta in zip(self._blocks, metas):
            node = getattr(meta, "node_id", None)
            placed = False
            if node is not None:
                for i, hint_node in enumerate(hint_nodes):
                    if hint_node == node and len(shards[i][0]) < cap:
                        shards[i][0].append(ref)
                        shards[i][1].append(meta)
                        placed = True
                        break
            if not placed:
                leftovers.append((ref, meta))
        for ref, meta in leftovers:
            i = min(range(n), key=lambda j: len(shards[j][0]))
            shards[i][0].append(ref)
            shards[i][1].append(meta)
        return [Dataset(refs, ms) for refs, ms in shards]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        rows = list(self.iter_rows())
        bounds = [0] + list(indices) + [len(rows)]
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            block = build_output_block(rows[lo:hi])
            meta = BlockAccessor.for_block(block).get_metadata()
            out.append(Dataset([ray_tpu_torch.put(block)], [meta]))
        return out

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        rng = random.Random(seed)
        return self.filter(lambda _r: rng.random() < fraction)

    # ----------------------------------------------------------- consumers
    def iter_rows(self) -> Iterator[Any]:
        for ref in self._blocks:
            block = ray_tpu_torch.get([ref])[0]
            yield from BlockAccessor.for_block(block).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = None,
                     batch_format: str = "native",
                     drop_last: bool = False) -> Iterator[Any]:
        buffer: List[Any] = []
        last_block: Optional[Block] = None
        for ref in self._blocks:
            block = ray_tpu_torch.get([ref])[0]
            last_block = block
            acc = BlockAccessor.for_block(block)
            if batch_size is None:
                if acc.num_rows():
                    yield acc.to_batch(batch_format)
                continue
            buffer.extend(acc.iter_rows())
            while len(buffer) >= batch_size:
                chunk, buffer = buffer[:batch_size], buffer[batch_size:]
                yield BlockAccessor.for_block(
                    build_output_block(chunk)).to_batch(batch_format)
        if buffer and not drop_last:
            yield BlockAccessor.for_block(
                build_output_block(buffer)).to_batch(batch_format)
        if batch_size is None and last_block is None:
            return

    @staticmethod
    def _split_features(batch: dict, columns, label_column):
        """columns-else-all-but-label feature split, shared by
        to_device/to_tf (one definition, one semantics)."""
        if columns:
            return {c: batch[c] for c in columns}
        return {k: v for k, v in batch.items() if k != label_column}

    def to_device(self, *, batch_size: int,
                  columns: Optional[List[str]] = None,
                  label_column: Optional[str] = None,
                  drop_last: bool = True,
                  device_put: bool = True,
                  device=None) -> Iterator[Any]:
        """Yield torch batches ready for a train step: the port of the JAX
        package's ``Dataset.to_jax``, with its signature, its batches and
        its structure (a dict of features, ``(features, labels)`` when
        ``label_column`` is given, or one tensor for non-table rows).

        Each numpy batch takes ``to_jax``'s dtypes, which ``jnp.asarray``
        gives with x64 off: int64, uint64, float64 and complex128 become
        int32, uint32, float32 and complex64, wrapping as numpy's
        ``astype`` does; a non-numeric column (object, string, datetime)
        raises ``TypeError``. The cast writes the batch into pinned host
        memory, which is copied to ``device`` without blocking, the
        counterpart of ``jax.device_put``'s asynchronous transfer; on the
        CPU the host tensor is the batch.

        ``device`` (None: CUDA) is resolved on the call, so a missing
        CUDA raises here, before the first batch. ``device_put=False``
        yields host tensors of those dtypes, for a caller who places
        them itself. Keep ``batch_size`` static so the step sees one
        shape."""
        device = resolve_device(device)
        batches = self.iter_batches(batch_size=batch_size,
                                    batch_format="numpy",
                                    drop_last=drop_last)
        return _feed(batches, columns, label_column,
                     device if device_put else None)

    def to_torch(self, *, batch_size: int,
                 label_column: Optional[str] = None,
                 drop_last: bool = False) -> Iterator[Any]:
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            if isinstance(batch, dict) and label_column is not None:
                feats = {k: torch.as_tensor(np.asarray(v))
                         for k, v in batch.items() if k != label_column}
                yield feats, torch.as_tensor(np.asarray(batch[label_column]))
            elif isinstance(batch, dict):
                yield {k: torch.as_tensor(np.asarray(v))
                       for k, v in batch.items()}
            else:
                yield torch.as_tensor(np.asarray(batch))

    def to_tf(self, *, batch_size: int,
              columns: Optional[List[str]] = None,
              label_column: Optional[str] = None,
              drop_last: bool = False):
        """A ``tf.data.Dataset`` over this dataset's blocks (reference:
        dataset.py to_tf): numpy column batches flow through
        ``from_generator`` with an inferred output signature, yielding
        ``features_dict`` or ``(features_dict, labels)``."""
        import tensorflow as tf

        def gen():
            for batch in self.iter_batches(batch_size=batch_size,
                                           batch_format="numpy",
                                           drop_last=drop_last):
                if not isinstance(batch, dict):
                    yield np.asarray(batch)
                    continue
                feats = {k: np.asarray(v) for k, v in
                         self._split_features(batch, columns,
                                              label_column).items()}
                if label_column is not None:
                    yield feats, np.asarray(batch[label_column])
                else:
                    yield feats

        # infer the signature from a ONE-ROW probe over limit(1):
        # dtypes + trailing shapes are batch-size-invariant, so this
        # avoids materializing (and discarding) a full first batch,
        # and a small dataset under drop_last=True still gets a
        # signature (yielding an empty tf Dataset, not an error)
        probe = next(iter(self.limit(1).to_tf_probe_batches(
            columns, label_column)), None)
        if probe is None:
            raise ValueError("to_tf on an empty dataset")

        def spec_of(arr):
            return tf.TensorSpec(shape=(None,) + arr.shape[1:],
                                 dtype=arr.dtype)

        if isinstance(probe, tuple):
            feats, labels = probe
            signature = ({k: spec_of(v) for k, v in feats.items()},
                         spec_of(labels))
        elif isinstance(probe, dict):
            signature = {k: spec_of(v) for k, v in probe.items()}
        else:
            signature = spec_of(probe)
        return tf.data.Dataset.from_generator(
            gen, output_signature=signature)

    def to_tf_probe_batches(self, columns, label_column):
        """One-row batches in to_tf's output structure (signature
        inference only)."""
        for batch in self.iter_batches(batch_size=1,
                                       batch_format="numpy"):
            if not isinstance(batch, dict):
                yield np.asarray(batch)
                continue
            feats = {k: np.asarray(v) for k, v in
                     self._split_features(batch, columns,
                                          label_column).items()}
            if label_column is not None:
                yield feats, np.asarray(batch[label_column])
            else:
                yield feats

    def to_pandas(self, limit: Optional[int] = None):
        import pandas as pd

        frames = []
        taken = 0
        for ref in self._blocks:
            block = ray_tpu_torch.get([ref])[0]
            frames.append(BlockAccessor.for_block(block).to_pandas())
            taken += len(frames[-1])
            if limit is not None and taken >= limit:
                break
        if not frames:
            return pd.DataFrame()
        df = pd.concat(frames, ignore_index=True)
        return df.head(limit) if limit is not None else df

    def to_numpy_refs(self) -> List["ray_tpu_torch.ObjectRef"]:
        @ray_tpu_torch.remote
        def _to_numpy(block):
            return BlockAccessor.for_block(block).to_numpy()
        return [_to_numpy.remote(ref) for ref in self._blocks]

    def to_arrow_refs(self) -> List["ray_tpu_torch.ObjectRef"]:
        @ray_tpu_torch.remote
        def _to_arrow(block):
            return BlockAccessor.for_block(block).to_arrow()
        return [_to_arrow.remote(ref) for ref in self._blocks]

    def take(self, limit: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    def count(self) -> int:
        metas = self._ensure_metadata()
        return sum(m.num_rows or 0 for m in metas)

    def _reduce_rows(self, fn, initial, key=None):
        acc = initial
        for row in self.iter_rows():
            v = _get_key(row, key) if key is not None else row
            acc = fn(acc, v)
        return acc

    def sum(self, on: Optional[Union[str, Callable]] = None):
        return self._reduce_rows(lambda a, b: a + b, 0, on)

    def min(self, on: Optional[Union[str, Callable]] = None):
        vals = [(_get_key(r, on) if on is not None else r)
                for r in self.iter_rows()]
        return min(vals) if vals else None

    def max(self, on: Optional[Union[str, Callable]] = None):
        vals = [(_get_key(r, on) if on is not None else r)
                for r in self.iter_rows()]
        return max(vals) if vals else None

    def mean(self, on: Optional[Union[str, Callable]] = None):
        vals = [(_get_key(r, on) if on is not None else r)
                for r in self.iter_rows()]
        return sum(vals) / len(vals) if vals else None

    def std(self, on: Optional[Union[str, Callable]] = None, ddof: int = 1):
        vals = np.array([(_get_key(r, on) if on is not None else r)
                         for r in self.iter_rows()], dtype=np.float64)
        return float(np.std(vals, ddof=ddof)) if len(vals) > ddof else None

    # --------------------------------------------------------------- write
    def write_parquet(self, path: str) -> None:
        from ray_tpu_torch.data.read_api import _write_blocks
        _write_blocks(self._blocks, path, "parquet")

    def write_csv(self, path: str) -> None:
        from ray_tpu_torch.data.read_api import _write_blocks
        _write_blocks(self._blocks, path, "csv")

    def write_json(self, path: str) -> None:
        from ray_tpu_torch.data.read_api import _write_blocks
        _write_blocks(self._blocks, path, "json")

    # ------------------------------------------------------------ pipeline
    def window(self, *, blocks_per_window: int = 10) -> "DatasetPipeline":
        from ray_tpu_torch.data.pipeline import DatasetPipeline
        return DatasetPipeline.from_dataset_windows(self, blocks_per_window)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        from ray_tpu_torch.data.pipeline import DatasetPipeline
        return DatasetPipeline.from_dataset_repeat(self, times)

    def fully_executed(self) -> "Dataset":
        ray_tpu_torch.get(self._blocks)
        return self

    def __repr__(self) -> str:
        metas = self._metadata
        rows = sum(m.num_rows or 0 for m in metas if m) if any(metas) else "?"
        return (f"Dataset(num_blocks={len(self._blocks)}, num_rows={rows}, "
                f"schema={_short_schema(self)})")


def _short_schema(ds: Dataset) -> str:
    try:
        s = ds.schema()
    except Exception:
        return "?"
    if s is None:
        return "None"
    if hasattr(s, "names"):
        return "{" + ", ".join(
            f"{n}: {t}" for n, t in zip(s.names, s.types)) + "}"
    return getattr(s, "__name__", str(s))


def _get_key(row: Any, key: Union[str, Callable, None]) -> Any:
    if key is None:
        return row
    if callable(key):
        return key(row)
    return row[key]


# the dtypes jnp.asarray gives numpy arrays with x64 off
_JAX_X32 = {np.dtype(np.int64): np.dtype(np.int32),
            np.dtype(np.uint64): np.dtype(np.uint32),
            np.dtype(np.float64): np.dtype(np.float32),
            np.dtype(np.complex128): np.dtype(np.complex64)}


def _to_tensor(arr, device):
    """One numpy array -> a tensor of ``to_jax``'s dtype, on ``device``
    (None: on the host)."""
    import torch

    arr = np.asarray(arr)
    if arr.dtype.kind not in "biufc":
        raise TypeError(f"Dtype {arr.dtype} is not a valid array type for "
                        f"the device feed: only numeric columns are")
    dtype = _JAX_X32.get(arr.dtype, arr.dtype)
    pinned = device is not None and device.type == "cuda"
    host = torch.empty(arr.shape, dtype=torch.from_numpy(
        np.empty(0, dtype)).dtype, pin_memory=pinned)
    np.copyto(host.numpy(), arr, casting="unsafe")
    if device is None or device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


def _feed(batches, columns, label_column, device) -> Iterator[Any]:
    """``to_device``'s generator over numpy batches."""
    for batch in batches:
        if isinstance(batch, dict):
            feats = Dataset._split_features(batch, columns, label_column)
            out = {k: _to_tensor(v, device) for k, v in feats.items()}
            if label_column is not None:
                out = (out, _to_tensor(batch[label_column], device))
        else:
            out = _to_tensor(batch, device)
        yield out
