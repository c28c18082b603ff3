"""Per-stage wall-clock tracing.

Counterpart of ``mpmvs_tpu.utils.trace``. ``StageTimer`` records named
spans with nesting, aggregated by stage (count / total / min / max), dumpable
as a table or JSON. The pipeline wraps every phase (solve, checkpoint,
fusion) so a run ends with a breakdown instead of one opaque number.

Timing convention: a span covers device work only if the caller
synchronizes before it closes — the pipeline calls :func:`device_sync`
(``torch.cuda.synchronize`` on a CUDA device) at the end of each solve.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List

import torch


def device_sync(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time in ms of ``fn()`` over ``reps`` back-to-back runs,
    after one warm-up run, from CUDA events on the current stream."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time in ms of one ``fn()`` without its host work: ``reps``
    calls captured in one CUDA graph (after a warm-up call outside it),
    the graph replayed ``replays`` times between CUDA events. Where a
    wrapper's checks and argument building take longer than its kernel,
    :func:`cuda_time_ms` times the host; this times the launches alone.
    ``fn`` must queue only capturable work on the current stream."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


class StageStats:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    def as_dict(self):
        return {"count": self.count, "total_s": self.total,
                "min_s": self.min, "max_s": self.max}


class StageTimer:
    """Aggregating span timer (single writer)."""

    def __init__(self):
        self.stats: Dict[str, StageStats] = {}
        self._stack: List[str] = []
        self._t_start = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a stage. Nested spans record under 'outer/inner'."""
        qual = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self.stats.setdefault(qual, StageStats()).add(
                time.perf_counter() - t0)

    def summary(self) -> str:
        wall = time.perf_counter() - self._t_start
        lines = [f"{'stage':<40} {'n':>5} {'total':>9} {'mean':>8} {'max':>8}"]
        for name in sorted(self.stats, key=lambda n: -self.stats[n].total):
            s = self.stats[name]
            lines.append(f"{name:<40} {s.count:>5} {s.total:>8.2f}s "
                         f"{s.total / s.count:>7.2f}s {s.max:>7.2f}s")
        lines.append(f"{'(wall)':<40} {'':>5} {wall:>8.2f}s")
        return "\n".join(lines)

    def as_dict(self):
        return {name: s.as_dict() for name, s in self.stats.items()}

    def dump_json(self, path: str):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"wall_s": time.perf_counter() - self._t_start,
                       "stages": self.as_dict()}, f, indent=1)
