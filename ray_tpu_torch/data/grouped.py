"""GroupedDataset + aggregate functions.

Reference: python/ray/data/grouped_dataset.py (AggregateFn protocol with
init/accumulate/merge/finalize; groupby is a hash-shuffle of rows to
per-key partitions followed by parallel per-partition aggregation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, build_output_block


@dataclass
class AggregateFn:
    init: Callable[[Any], Any]
    accumulate: Callable[[Any, Any], Any]
    merge: Callable[[Any, Any], Any]
    finalize: Callable[[Any], Any]
    name: str = "agg"


def _on_fn(on: Union[str, Callable, None]) -> Callable:
    if on is None:
        return lambda r: r
    if callable(on):
        return on
    return lambda r: r[on]


def Count() -> AggregateFn:
    return AggregateFn(lambda k: 0, lambda a, r: a + 1, lambda a, b: a + b,
                       lambda a: a, "count()")


def Sum(on=None) -> AggregateFn:
    f = _on_fn(on)
    return AggregateFn(lambda k: 0, lambda a, r: a + f(r),
                       lambda a, b: a + b, lambda a: a, f"sum({on})")


def Min(on=None) -> AggregateFn:
    f = _on_fn(on)
    return AggregateFn(lambda k: None,
                       lambda a, r: f(r) if a is None else min(a, f(r)),
                       lambda a, b: b if a is None else
                       (a if b is None else min(a, b)),
                       lambda a: a, f"min({on})")


def Max(on=None) -> AggregateFn:
    f = _on_fn(on)
    return AggregateFn(lambda k: None,
                       lambda a, r: f(r) if a is None else max(a, f(r)),
                       lambda a, b: b if a is None else
                       (a if b is None else max(a, b)),
                       lambda a: a, f"max({on})")


def Mean(on=None) -> AggregateFn:
    f = _on_fn(on)
    return AggregateFn(lambda k: (0.0, 0),
                       lambda a, r: (a[0] + f(r), a[1] + 1),
                       lambda a, b: (a[0] + b[0], a[1] + b[1]),
                       lambda a: a[0] / a[1] if a[1] else None,
                       f"mean({on})")


def Std(on=None, ddof: int = 1) -> AggregateFn:
    f = _on_fn(on)

    def _finalize(a):
        s, s2, n = a
        if n <= ddof:
            return None
        var = (s2 - s * s / n) / (n - ddof)
        return max(var, 0.0) ** 0.5

    return AggregateFn(lambda k: (0.0, 0.0, 0),
                       lambda a, r: (a[0] + f(r), a[1] + f(r) ** 2, a[2] + 1),
                       lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2]),
                       _finalize, f"std({on})")


class GroupedDataset:
    def __init__(self, dataset, key: Union[str, Callable, None]):
        self._dataset = dataset
        self._key = key

    def _key_fn(self) -> Callable:
        key = self._key
        if key is None:
            return lambda r: None
        if callable(key):
            return key
        return lambda r: r[key]

    def aggregate(self, *aggs: AggregateFn):
        """Hash-partition rows by key across tasks, aggregate partitions in
        parallel, merge on the driver."""
        from ray_tpu_torch.data.dataset import Dataset

        kf = self._key_fn()
        nparts = max(self._dataset.num_blocks(), 1)

        @ray_tpu_torch.remote(num_returns=max(nparts, 1))
        def partition(block):
            parts: List[list] = [[] for _ in range(nparts)]
            for r in BlockAccessor.for_block(block).iter_rows():
                parts[hash(kf(r)) % nparts].append(r)
            out = [build_output_block(p) for p in parts]
            return out if nparts > 1 else out[0]

        @ray_tpu_torch.remote
        def agg_partition(*parts):
            states: dict = {}
            for p in parts:
                for r in BlockAccessor.for_block(p).iter_rows():
                    k = kf(r)
                    if k not in states:
                        states[k] = [a.init(k) for a in aggs]
                    st = states[k]
                    for i, a in enumerate(aggs):
                        st[i] = a.accumulate(st[i], r)
            return states

        map_out = [partition.remote(ref)
                   for ref in self._dataset.get_internal_block_refs()]
        if nparts == 1:
            map_out = [[m] for m in map_out]
        part_states = ray_tpu_torch.get([
            agg_partition.remote(*[m[j] for m in map_out])
            for j in range(nparts)])
        merged: dict = {}
        for states in part_states:
            for k, st in states.items():
                if k not in merged:
                    merged[k] = st
                else:
                    merged[k] = [a.merge(x, y) for a, x, y in
                                 zip(aggs, merged[k], st)]
        rows = []
        for k in sorted(merged.keys(), key=lambda x: (x is None, x)):
            finals = [a.finalize(s) for a, s in zip(aggs, merged[k])]
            if isinstance(self._key, str):
                row = {self._key: k}
                for a, v in zip(aggs, finals):
                    row[a.name] = v
                rows.append(row)
            elif len(aggs) == 1:
                rows.append((k, finals[0]) if self._key is not None
                            else finals[0])
            else:
                rows.append((k, *finals))
        block = build_output_block(rows)
        meta = BlockAccessor.for_block(block).get_metadata()
        return Dataset([ray_tpu_torch.put(block)], [meta])

    def count(self):
        return self.aggregate(Count())

    def sum(self, on=None):
        return self.aggregate(Sum(on))

    def min(self, on=None):
        return self.aggregate(Min(on))

    def max(self, on=None):
        return self.aggregate(Max(on))

    def mean(self, on=None):
        return self.aggregate(Mean(on))

    def std(self, on=None, ddof: int = 1):
        return self.aggregate(Std(on, ddof))

    def map_groups(self, fn: Callable[[List[Any]], Any]):
        """Apply fn to the full row list of each group."""
        from ray_tpu_torch.data.dataset import Dataset

        kf = self._key_fn()
        groups: dict = {}
        for r in self._dataset.iter_rows():
            groups.setdefault(kf(r), []).append(r)

        @ray_tpu_torch.remote
        def apply(rows):
            out = fn(rows)
            return out if isinstance(out, list) else [out]

        results = ray_tpu_torch.get([apply.remote(v) for _, v in
                               sorted(groups.items(),
                                      key=lambda kv: (kv[0] is None, kv[0]))])
        rows = [r for rs in results for r in rs]
        block = build_output_block(rows)
        meta = BlockAccessor.for_block(block).get_metadata()
        return Dataset([ray_tpu_torch.put(block)], [meta])
