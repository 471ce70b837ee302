"""Per-stage dataset statistics (reference: python/ray/data/impl/stats.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StageStats:
    name: str
    wall_time_s: float
    num_blocks: int
    num_rows: int
    size_bytes: int


@dataclass
class DatasetStats:
    stages: List[StageStats] = field(default_factory=list)

    def child(self, name: str, wall_time_s: float, metas) -> "DatasetStats":
        rows = sum((m.num_rows or 0) for m in metas if m)
        size = sum((m.size_bytes or 0) for m in metas if m)
        new = DatasetStats(list(self.stages))
        new.stages.append(StageStats(name, wall_time_s, len(metas), rows,
                                     size))
        return new

    def summary(self) -> str:
        lines = []
        for s in self.stages:
            lines.append(
                f"Stage {s.name}: {s.num_blocks} blocks, {s.num_rows} rows, "
                f"{s.size_bytes} bytes, {s.wall_time_s * 1e3:.2f}ms")
        return "\n".join(lines) or "(no stages executed)"
