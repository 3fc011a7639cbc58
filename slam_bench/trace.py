"""The traced run's instruments: spans around the program's stages, a
wrapper that reads each fused-matcher call's shape, and one
``torch.profiler`` span in the middle of the window, reduced to what the
per-layer metrics read.

The busy share is the union of the device's operations (kernels, copies,
sets) over the span: operations of two streams that overlap count once.
Launch counts are the CUDA runtime's launch calls.  The arithmetic follows
``tools/profile_torch_slam.py`` at commit 359566b, which sums kernel times
(and so can count an overlap twice).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict

import torch

from . import roofline

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
PARTIAL = "match_partial_kernel"
GATED_PARTIAL = "match_partial_kernel<true>"
MERGE = "match_merge_kernel"


class StageSpans:
    """Replaces ``timer.stage`` of the program's ``StageTimer``: each stage
    is also kept as (name, start, end, thread) and marked as a
    ``record_function`` range ``stage/<name>`` for the profiler."""

    def __init__(self, timer):
        self.spans = []
        orig = timer.stage

        @contextlib.contextmanager
        def stage(name):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"stage/{name}"), orig(name):
                    yield
            finally:
                self.spans.append((name, t0, time.perf_counter(), threading.get_ident()))

        timer.stage = stage


class MatchCalls:
    """Wraps ``tracker.fused_match``: while ``active``, keeps each call's
    inputs (references; none of them is written later) for the counts of
    ``roofline.fused_match_bound_ms``."""

    def __init__(self, tracker_module):
        self.mod = tracker_module
        self.orig = tracker_module.fused_match
        self.active = False
        self.calls = []

        def fused_match(desc_q, desc_p, uv_q, uv_p, radius, valid_q, valid_p, **kw):
            out = self.orig(desc_q, desc_p, uv_q, uv_p, radius, valid_q, valid_p, **kw)
            if self.active:
                self.calls.append((uv_q, uv_p, float(radius), valid_q, valid_p))
            return out

        tracker_module.fused_match = fused_match

    def bounds_ms(self):
        return [roofline.fused_match_bound_ms(*c) for c in self.calls]


class Profiled:
    """One profiler span, bracketed by device synchronisations (on the CPU,
    for tests, the host's events alone)."""

    def __init__(self, cuda=True):
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self):
        """Reduce the span's events: busy seconds, launches, device ops by
        name, idle time by the host stage it fell in, and the fused
        matcher's device time."""
        events = self.prof.profiler.kineto_results.events()
        dev, stages, launches = [], [], 0
        partial, merge = [], []
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation() or name.startswith("stage/"):
                    continue
                s, d = e.start_ns(), e.duration_ns()
                dev.append((s, s + d, name))
                if PARTIAL in name:
                    partial.append((e.correlation_id(), d, GATED_PARTIAL in name))
                elif MERGE in name:
                    merge.append((e.correlation_id(), d))
            elif name in LAUNCH_CALLS:
                launches += 1
            elif name.startswith("stage/"):
                stages.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[6:]))
        dev.sort()
        busy, gaps = 0, []
        cur_s = cur_e = None
        for s, e, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        by_name = defaultdict(int)
        for s, e, n in dev:
            by_name[n] += e - s
        # idle time by the innermost host stage that holds the gap's middle
        # (stages nest: the latest-starting one that holds it)
        stages.sort()
        starts = [r[0] for r in stages]
        idle_by = defaultdict(int)
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            i = j = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and stages[i][1] < mid and j - i < 8:
                i -= 1
            name = stages[i][2] if i >= 0 and stages[i][1] >= mid else "outside stages"
            idle_by[name] += g1 - g0
        # each merge kernel belongs to the partial launched just before it
        partial.sort()
        p_ids = [c for c, _, _ in partial]
        match_ns = sum(d for _, d, gated in partial if gated)
        for c, d in merge:
            i = bisect.bisect_left(p_ids, c) - 1
            if i >= 0 and partial[i][2]:
                match_ns += d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": self.t1 - self.t0,
            "busy_s": busy / 1e9,
            "n_device_ops": len(dev),
            "launches": launches,
            "gated_match_kernels": sum(1 for p in partial if p[2]),
            "fused_match_device_s": match_ns / 1e9,
            "device_ops": [[n, v / 1e9] for n, v in top],
            "idle_gaps": [[n, v / 1e9] for n, v in idle],
        }
