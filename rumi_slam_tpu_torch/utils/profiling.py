"""Per-stage wall-clock timing (port of ``StageTimer`` of
``rumi_slam_tpu/utils/profiling.py``; ``MemoryMonitor`` and ``device_trace``
are not ported yet).

The timer reads the host clock.  On the card a stage's time is what the
host spent in it, including any device sync the stage makes (a host read
of a device value waits for the work queued before it)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "n": len(a),
                "mean_ms": float(a.mean() * 1e3),
                "median_ms": float(np.median(a) * 1e3),
                "max_ms": float(a.max() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        rows = ["stage                          n    mean     med     max   total"]
        for name, s in sorted(self.stats().items()):
            rows.append(
                f"{name:28s} {s['n']:4d} {s['mean_ms']:7.2f} "
                f"{s['median_ms']:7.2f} {s['max_ms']:7.2f} {s['total_s']:7.2f}s"
            )
        return "\n".join(rows)
