"""DatasetPipeline — windowed / repeated streaming over a Dataset.

Reference: python/ray/data/dataset_pipeline.py. A pipeline is a lazy
iterator of Datasets (windows); per-window transforms are recorded and
applied as each window is produced, overlapping epochs with consumption.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

from ray_tpu_torch._private.device import resolve_device


class DatasetPipeline:
    def __init__(self, window_fn: Callable[[], Iterator["Dataset"]],
                 length: Optional[int] = None):
        self._window_fn = window_fn
        self._length = length
        self._stages: List[Callable[["Dataset"], "Dataset"]] = []

    # ------------------------------------------------------------ creation
    @classmethod
    def from_dataset_windows(cls, ds, blocks_per_window: int
                             ) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset import Dataset

        refs = ds.get_internal_block_refs()
        metas = ds._ensure_metadata()

        def gen():
            for i in range(0, len(refs), blocks_per_window):
                yield Dataset(refs[i:i + blocks_per_window],
                              metas[i:i + blocks_per_window])

        n = (len(refs) + blocks_per_window - 1) // max(blocks_per_window, 1)
        return cls(gen, n)

    @classmethod
    def from_dataset_repeat(cls, ds, times: Optional[int]
                            ) -> "DatasetPipeline":
        def gen():
            i = 0
            while times is None or i < times:
                yield ds
                i += 1

        return cls(gen, times)

    # ---------------------------------------------------------- transforms
    def _with_stage(self, stage: Callable) -> "DatasetPipeline":
        p = DatasetPipeline(self._window_fn, self._length)
        p._stages = self._stages + [stage]
        return p

    def map(self, fn, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.map(fn, **kw))

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.map_batches(fn, **kw))

    def filter(self, fn, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.filter(fn, **kw))

    def flat_map(self, fn, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.flat_map(fn, **kw))

    def random_shuffle_each_window(self, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.random_shuffle(**kw))

    def repartition_each_window(self, n: int, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.repartition(n, **kw))

    def foreach_window(self, fn: Callable) -> "DatasetPipeline":
        return self._with_stage(fn)

    # ----------------------------------------------------------- consumers
    def iter_datasets(self) -> Iterator["Dataset"]:
        for ds in self._window_fn():
            for stage in self._stages:
                ds = stage(ds)
            yield ds

    def iter_rows(self) -> Iterator[Any]:
        for ds in self.iter_datasets():
            yield from ds.iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        for ds in self.iter_datasets():
            yield from ds.iter_batches(**kw)

    def to_device(self, *, device=None, **kw) -> Iterator[Any]:
        """Each window's ``Dataset.to_device`` batches in turn (the port
        of ``to_jax``); ``device`` is resolved on the call."""
        device = resolve_device(device)

        def gen():
            for ds in self.iter_datasets():
                yield from ds.to_device(device=device, **kw)
        return gen()

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def count(self) -> int:
        return sum(ds.count() for ds in self.iter_datasets())

    def split(self, n: int) -> List["DatasetPipeline"]:
        """Split each window across n consumers (for per-worker shards)."""
        outs = []
        for i in range(n):
            def gen(i=i):
                for ds in self.iter_datasets():
                    yield ds.split(n)[i]
            outs.append(DatasetPipeline(gen, self._length))
        return outs

    def __repr__(self) -> str:
        return (f"DatasetPipeline(num_windows={self._length}, "
                f"num_stages={len(self._stages)})")
