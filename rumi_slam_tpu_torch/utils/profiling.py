"""Per-stage wall-clock timing and a background RSS sampler (port of
``rumi_slam_tpu/utils/profiling.py``).

The timer reads the host clock.  On the card a stage's time is what the
host spent in it, including any device sync the stage makes (a host read
of a device value waits for the work queued before it).  While a
``torch.profiler`` records on the calling thread, each stage is also a
``record_function`` range ``slam/<name>``, so the stages lie on the device
trace's clock; with no profiler a stage costs one flag check more."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import numpy as np
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function


class StageTimer:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            if _profiler_enabled():
                with record_function(f"slam/{name}"):
                    yield
            else:
                yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self) -> dict:
        out = {}
        # a copy: the mapping worker's thread may add a stage meanwhile
        for name, xs in list(self.samples.items()):
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


def stage(timer: StageTimer | None, name: str):
    """``timer.stage(name)``, or a context that records nothing when there is
    no timer (the optional ``timer`` argument of the tracking and mapping
    functions)."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


class MemoryMonitor:
    """Background RSS sampler, the reference's memory-usage publisher
    (scripts/nodes/pub_memory.py: RSS at 1 Hz, harvested into result.csv).
    Samples (t, rss_bytes) into a list while the ``with`` block runs."""

    def __init__(self, interval_s: float = 1.0):
        self.interval_s = interval_s
        self.samples: list[tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _rss(self) -> int:
        from ..runtime import native

        rss = native.rss_bytes()
        if rss >= 0:
            return rss
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        t0 = time.perf_counter()
        while not self._stop.wait(self.interval_s):
            self.samples.append((time.perf_counter() - t0, self._rss()))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    def peak_mb(self) -> float:
        return max((s[1] for s in self.samples), default=self._rss()) / 1e6

    def mean_mb(self) -> float:
        if not self.samples:
            return self._rss() / 1e6
        return float(np.mean([s[1] for s in self.samples])) / 1e6

