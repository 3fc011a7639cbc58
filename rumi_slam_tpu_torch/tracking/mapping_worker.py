"""Local mapping as a snapshot-in / snapshot-out round, run inline or on a
worker thread (port of ``rumi_slam_tpu/tracking/mapping_worker.py``; the
loop-closing branch is ROADMAP queue 1 item 11 and raises).

* The tracker inserts a keyframe and submits that MapState snapshot; one
  task is in flight at a time (keyframes are only created while the worker
  is idle).
* The worker runs the round (triangulation, duplicate fusion, windowed BA,
  culling) on the snapshot and produces a new MapState.  No function of the
  round writes into a tensor of its input, so the snapshot stays as it was.
* The tracker adopts the result at a frame boundary by a three-way merge.

On the card the worker thread runs on the default stream, as the tracker
does: the device runs the two in order and only the host work overlaps.
The worker records a CUDA event after its round and waits on it before it
publishes the result.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import NamedTuple, Optional

import torch

from ..mapstate import map_state as M
from . import local_mapping


class MappingTask(NamedTuple):
    ms: M.MapState          # snapshot including the freshly inserted KF
    kf_id: int
    use_stereo: bool
    draw: object            # RANSAC draw of the loop-closing round (unused while
                            # loop closing is not ported; drawn all the same)
    kf_count: int           # stats["n_kf"] at submit (culling cadence)


class MappingOutcome(NamedTuple):
    snap: M.MapState        # the submitted snapshot (for the three-way merge)
    mapped: M.MapState      # the worker's version
    events: dict            # {"n_new": int, "n_fused": int, "loop": bool}


def run_mapping_round(ms: M.MapState, K, cfg, kf_id: int, *, use_stereo: bool, draw,
                      kf_count: int) -> MappingOutcome:
    """One local-mapping round as a pure MapState -> MapState function."""
    if cfg.mapping.loop_closing:
        raise NotImplementedError(
            "loop closing is not ported to rumi_slam_tpu_torch yet (ROADMAP.md queue 1, "
            "item 11: loop closing); set cfg.mapping.loop_closing=False")
    snap = ms
    events = {"n_new": 0, "n_fused": 0, "loop": False}
    cam = cfg.camera
    # triangulate against the best covisible neighbours (one host read for
    # the window)
    ids, valid_w = M.local_window(ms, kf_id, window=5)
    ids = ids.tolist()
    valid_w = valid_w.tolist()
    new_counts = []
    for j in range(1, 5):
        if valid_w[j] and ids[j] != int(kf_id):
            ms, n_new = local_mapping.triangulate_with_neighbor(ms, K, kf_id, ids[j])
            new_counts.append(n_new)
    if new_counts:
        events["n_new"] += int(torch.sum(torch.stack(new_counts)))
    ms, n_fused = local_mapping.fuse_with_neighbors(
        ms, K, kf_id, window=4, img_w=cam.width, img_h=cam.height)
    events["n_fused"] = int(n_fused)
    ms = local_mapping.local_bundle_adjustment(
        ms, K, kf_id,
        window=cfg.mapping.local_window,
        n_iters=cfg.mapping.local_ba_iters,
        use_stereo=use_stereo,
        bf=cam.bf,
        fixed_ring=cfg.mapping.lba_fixed_ring,
    )
    ms = local_mapping.cull_points(ms)
    ms = M.refresh_point_descriptors(ms, kf_id)
    if cfg.mapping.kf_culling and kf_count % 4 == 0:
        ms = local_mapping.cull_keyframes(ms, kf_id)
    return MappingOutcome(snap=snap, mapped=ms, events=events)


def merge_mapping_result(cur: M.MapState, snap: M.MapState, mapped: M.MapState) -> M.MapState:
    """Three-way adoption of a worker result into the tracker's current map.

    The worker owns every KF row that existed at snapshot time and all point
    storage; the tracker owns the rows it appended since and the per-point
    visible/found counters, which both sides advance and which merge by
    adding both increments."""
    old = torch.arange(cur.max_kf, device=cur.n_kf.device) < snap.n_kf
    return cur._replace(
        kf_pose=torch.where(old[:, None], mapped.kf_pose, cur.kf_pose),
        kf_point=torch.where(old[:, None], mapped.kf_point, cur.kf_point),
        kf_valid=torch.where(old, mapped.kf_valid, cur.kf_valid),
        pt_xyz=mapped.pt_xyz,
        pt_desc=mapped.pt_desc,
        pt_valid=mapped.pt_valid,
        pt_map_id=mapped.pt_map_id,
        pt_ref_kf=mapped.pt_ref_kf,
        pt_octave=mapped.pt_octave,
        pt_angle=mapped.pt_angle,
        pt_visible=mapped.pt_visible + (cur.pt_visible - snap.pt_visible),
        pt_found=mapped.pt_found + (cur.pt_found - snap.pt_found),
        n_pt=mapped.n_pt,
    )


class MappingWorker:
    """One background thread, one in-flight task, one pending result."""

    def __init__(self, cfg, K):
        self.cfg = cfg
        self.K = K
        self._tasks: queue.Queue[Optional[MappingTask]] = queue.Queue(1)
        self._result: Optional[MappingOutcome] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._busy = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- worker side ---------------------------------------------------
    def _run(self):
        while True:
            task = self._tasks.get()
            if task is None:
                return
            try:
                out = run_mapping_round(task.ms, self.K, self.cfg, task.kf_id,
                                        use_stereo=task.use_stereo, draw=task.draw,
                                        kf_count=task.kf_count)
                if out.mapped.kf_pose.is_cuda:
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
                with self._lock:
                    self._result = out
                    self._busy = False
            except BaseException as e:  # keep the loop alive; re-raise on
                with self._lock:        # the tracker side (poll/flush)
                    self._error = e
                    self._busy = False

    # -- tracker side --------------------------------------------------
    def idle(self) -> bool:
        """True when no task is in flight and no result awaits adoption."""
        with self._lock:
            return not self._busy and self._result is None

    def submit(self, ms, kf_id, *, use_stereo, draw, kf_count) -> bool:
        with self._lock:
            if self._busy or self._result is not None:
                return False
            self._busy = True
        self._tasks.put(MappingTask(ms, int(kf_id), bool(use_stereo), draw, int(kf_count)))
        return True

    def _raise_pending(self):
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("mapping worker round failed") from err

    def poll(self) -> Optional[MappingOutcome]:
        with self._lock:
            self._raise_pending()
            out, self._result = self._result, None
            return out

    def flush(self, timeout: float = 600.0) -> Optional[MappingOutcome]:
        """Wait for the in-flight task (if any) and return its result; called
        before structural host events so that one writer touches the map."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._busy:
                    self._raise_pending()
                    out, self._result = self._result, None
                    return out
            time.sleep(0.002)
        raise TimeoutError("mapping worker did not finish in time")

    def shutdown(self):
        self._tasks.put(None)
        self._thread.join(timeout=10.0)
