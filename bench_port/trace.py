"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

``Tracer`` profiles a stretch of the measured window (CPU and CUDA
activity, no shapes or stacks); ``summary`` reduces it to what the
per-layer readers and the result line take: the seconds in which some
operation ran on the device (the union of their intervals), the length
of the traced stretch, device seconds by kernel group, the device
operations that took most time, and the idle gaps by what the host was
doing then (the innermost ``bench.*`` range the harness opened in the
thread that started the profiler; ``bench.outside`` where none was open
there, as while a replica waits for its next batch). The profiler
records CPU ranges of that thread alone: recording every thread's slows
a serving replica's host path enough to back its queue up.
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

# substrings of kernel names: the port's K1-K3, and cuBLAS/CUTLASS GEMMs
KERNEL_GROUPS = (("attn_fwd", ("flash_fwd", "fwd_dchunk", "fwd_ring")),
                 ("attn_dq", ("bwd_dq",)),
                 ("attn_dkdv", ("bwd_dkdv",)),
                 ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                             "matmul")))
TOP = 10
SHORT_GAP_S = 20e-6


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, tags in KERNEL_GROUPS:
        if any(tag in low for tag in tags):
            return group
    return "other"


class Tracer:
    """One profiled stretch: ``start()`` ... ``stop()``; on the CPU (no
    CUDA activity to trace) both are no-ops and ``summary`` is None."""

    def __init__(self, device: str):
        self._cuda = device == "cuda"
        self._prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        if not self._cuda:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self._prof.stop()

    def summary(self) -> Optional[dict]:
        if self._prof is None:
            return None
        return summarize(self._prof.events(), self.t1 - self.t0)


class ThreadTracer(Tracer):
    """A ``Tracer`` whose profiler starts and stops on a thread of its
    own, for a caller that reaches ``start()`` and ``stop()`` from two
    threads (the profiler must be stopped by the thread that started
    it). The thread ends after ``stop()``."""

    def __init__(self, device: str):
        super().__init__(device)
        self._jobs: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while True:
            job, done = self._jobs.get()
            job()
            done.set()
            if job == self._stop:
                return

    def _run(self, job) -> None:
        done = threading.Event()
        self._jobs.put((job, done))
        done.wait()

    def _stop(self) -> None:
        Tracer.stop(self)

    def start(self) -> None:
        self._run(lambda: Tracer.start(self))

    def stop(self) -> None:
        self._run(self._stop)
        self._thread.join()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def summarize(events, window_s: float) -> dict:
    from torch.autograd import DeviceType

    device, ranges = [], []
    for evt in events:
        span = (evt.time_range.start, evt.time_range.end)  # us
        if evt.name.startswith("bench."):  # also mirrored on the device
            if evt.device_type != DeviceType.CUDA:
                ranges.append((evt.name, span))
        elif evt.device_type == DeviceType.CUDA:
            device.append((evt.name, span))
    if not device:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy = _merge([span for _, span in device])
    groups: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for name, (a, b) in device:
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) \
            + (b - a) / 1e6
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    gaps: Dict[str, float] = {}
    ranges.sort(key=lambda r: r[1][0])
    starts = [span[0] for _, span in ranges]
    for (_, prev_end), (next_start, _) in zip(busy, busy[1:]):
        gap = (next_start - prev_end) / 1e6
        if gap < SHORT_GAP_S:
            label = "launch gaps under 20 us"
        else:
            mid = (prev_end + next_start) / 2
            i = bisect.bisect_right(starts, mid)
            inner = [(b - a, name) for name, (a, b) in
                     ranges[max(0, i - 64):i] if mid <= b]
            label = min(inner)[1] if inner else "bench.outside"
        gaps[label] = gaps.get(label, 0.0) + gap
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": window_s,
        "group_s": groups,
        "device_ops": [[name[:160], s] for name, s in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }
