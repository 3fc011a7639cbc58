"""Asynchronous rumination shard: the edge/cloud split on one card (port of
``rumi_slam_tpu/rumination/remote.py``).

A worker thread runs ``backend.build`` while the realtime tracker goes on.
On the card the build runs under a CUDA stream of its own (the backend's
``SlamSystem`` is a second system with its own MapState on the same card).
The worker synchronises that stream, copies the CloudMap into memory of the
default stream and waits for the copy before it hands the map over: every
tensor of the result is complete before the coordinator's default-stream
work reads it, and none of them lives in the side stream's memory pool,
which a later build reuses.  Bundles come in as lists of host frames;
results go back as CloudMaps.  No locks are shared with the tracker: the
coordinator polls ``poll`` once per frame.

A build that raises is reported to the coordinator as a failed build
(``None``), and the exception is kept in ``last_error`` for the caller to
check.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import torch

from ..config import Config
from . import cloud_map
from .backend import RuminationBackend
from .sampler import RecordedFrame


class AsyncRuminationShard:
    """Worker-thread wrapper around a RuminationBackend."""

    def __init__(self, config: Config, *, device=None,
                 backend: Optional[RuminationBackend] = None):
        """``device``: where the shard's own backend runs (the card by
        default; a host without one raises; ``"cpu"`` for the CPU).  A backend
        handed in brings its device with it: naming another one raises."""
        self.cfg = config
        own = getattr(backend, "device", None)
        if own is not None and device is not None and not _same_device(own, device):
            raise ValueError(f"AsyncRuminationShard: device {str(device)!r} asked for, but "
                             f"the backend handed in runs on {str(own)!r}")
        self.device = torch.device(own if own is not None
                                   else "cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"AsyncRuminationShard: device {str(self.device)!r} asked for and no CUDA "
                "device is present (pass device=\"cpu\" to run on the CPU)")
        self.backend = backend or RuminationBackend(config, device=self.device)
        self.last_error: Optional[BaseException] = None
        self._in: queue.Queue = queue.Queue(maxsize=2)
        self._out: queue.Queue = queue.Queue()
        self._busy = threading.Event()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side (tracking loop) -----------------------------------
    def submit(self, job_id: int, bundle: list[RecordedFrame], anchor_times=(),
               anchor_split=None) -> bool:
        """Non-blocking; returns False if the shard is saturated."""
        if self._busy.is_set():
            return False
        try:
            self._in.put_nowait((job_id, bundle, tuple(anchor_times), anchor_split))
        except queue.Full:
            return False
        self._busy.set()
        return True

    def poll(self) -> Optional[tuple[int, Optional[cloud_map.CloudMap]]]:
        """(job_id, CloudMap-or-None) when a build finished, else None."""
        try:
            return self._out.get_nowait()
        except queue.Empty:
            return None

    @property
    def busy(self) -> bool:
        return self._busy.is_set()

    def shutdown(self):
        self._stop.set()
        self._in.put(None)
        self._worker.join(timeout=10)

    # -- shard side -----------------------------------------------------
    def _build(self, bundle, anchors, split):
        if self.device.type != "cuda":
            return self.backend.build(bundle, anchor_times=anchors, anchor_split=split)
        stream = torch.cuda.Stream(self.device)
        # work queued so far on the default stream (none of it is the build's
        # input: the bundle is host memory) need not be waited for
        with torch.cuda.stream(stream):
            cm = self.backend.build(bundle, anchor_times=anchors, anchor_split=split)
        stream.synchronize()
        if cm is not None:
            cm = cloud_map.CloudMap(*(None if t is None else t.clone() for t in cm))
            torch.cuda.current_stream(self.device).synchronize()
        return cm

    def _run(self):
        while not self._stop.is_set():
            item = self._in.get()
            if item is None:
                break
            job_id, bundle, anchors, split = item
            try:
                cm = self._build(bundle, anchors, split)
            except Exception as e:
                self.last_error = e
                cm = None
            self._out.put((job_id, cm))
            self._busy.clear()


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def pick_rumination_device():
    """Where to place the rumination shard: with several cards, the last one;
    with one device, None (the backend shares the tracker's device)."""
    if torch.cuda.device_count() <= 1:
        return None
    return torch.device("cuda", torch.cuda.device_count() - 1)
