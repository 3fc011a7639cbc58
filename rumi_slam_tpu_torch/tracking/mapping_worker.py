"""Local mapping as a snapshot-in / snapshot-out round, run inline or on a
worker thread (port of ``rumi_slam_tpu/tracking/mapping_worker.py``).

* The tracker inserts a keyframe and submits that MapState snapshot; one
  task is in flight at a time (keyframes are only created while the worker
  is idle).
* The worker runs the round (triangulation, duplicate fusion, windowed BA,
  culling, cadenced loop closing) on the snapshot and produces a new
  MapState.  No function of the round writes into a tensor of its input, so
  the snapshot stays as it was.
* The tracker adopts the result at a frame boundary by a three-way merge
  (``SlamSystem.ADOPT_AFTER`` frames after the keyframe, waiting for the
  worker there if need be).

On the card the worker thread runs its round on the stream that was current
where the task was submitted (the default stream, unless the caller runs the
system under a stream of its own), so the snapshot it reads is complete:
the device runs tracker and worker in order and only the host work overlaps.
The worker records a CUDA event after its round and waits on it before it
publishes the result.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import NamedTuple, Optional

import torch

from ..mapstate import map_state as M
from ..utils.profiling import stage
from . import local_mapping, loop_closing


class MappingTask(NamedTuple):
    ms: M.MapState          # snapshot including the freshly inserted KF
    kf_id: int
    use_stereo: bool
    draw: object            # RANSAC draw of the loop-closing verification
    kf_count: int           # stats["n_kf"] at submit (culling/loop cadence)
    stream: object = None   # the submitter's CUDA stream (None on the CPU)


class MappingOutcome(NamedTuple):
    snap: M.MapState        # the submitted snapshot (for the three-way merge)
    mapped: M.MapState      # the worker's version
    events: dict            # {"n_new": int, "n_fused": int, "loop": bool}


def run_mapping_round(ms: M.MapState, K, cfg, kf_id: int, *, use_stereo: bool, draw,
                      kf_count: int, timer=None) -> MappingOutcome:
    """One local-mapping round as a pure MapState -> MapState function.
    ``timer``: an optional ``StageTimer``; the local BA is its ``local_ba``
    stage, the loop-closing block its ``loop_closing`` stage."""
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
    with stage(timer, "local_ba"):
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
    mc = cfg.mapping
    if mc.loop_closing and kf_count % mc.loop_check_interval == 0:
        with stage(timer, "loop_closing"):
            ms = _loop_closing_round(ms, K, mc, kf_id, draw, events)
    return MappingOutcome(snap=snap, mapped=ms, events=events)


def _loop_closing_round(ms, K, mc, kf_id, draw, events):
    """Detect, verify and (on enough inliers) close a loop at ``kf_id``;
    writes ``loop``, ``loop_best_score`` and ``loop_verify_inliers`` into
    ``events``."""
    cand = loop_closing.detect_loop_candidates(ms, kf_id)
    cand_ids, cand_scores = cand.kf_id.tolist(), cand.score.tolist()
    events["loop_best_score"] = int(cand_scores[0])
    for cand_kf, score in zip(cand_ids, cand_scores):
        if int(score) < mc.loop_min_score:
            break
        S, n_inl, _ = loop_closing.verify_loop(draw, K, ms, kf_id, cand_kf)
        n_inl = int(n_inl)
        # how close verification gets when loops do not close
        events["loop_verify_inliers"] = max(events.get("loop_verify_inliers", 0), n_inl)
        if n_inl >= mc.loop_min_inliers:
            ms = loop_closing.close_loop(ms, K, kf_id, cand_kf, S)
            events["loop"] = True
            if mc.loop_gba_iters > 0:
                # the round is the background thread: run the global BA
                # inline on the graph-corrected map
                ms = local_mapping.global_bundle_adjustment(
                    ms, K, int(ms.kf_map_id[kf_id]), n_iters=mc.loop_gba_iters)
            break
    return ms


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

    def __init__(self, cfg, K, timer=None):
        self.cfg = cfg
        self.K = K
        self.timer = timer
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
                # a new thread starts on the default stream: take the submitter's
                with (torch.cuda.stream(task.stream) if task.stream is not None
                      else contextlib.nullcontext()), stage(self.timer, "mapping_round"):
                    out = run_mapping_round(task.ms, self.K, self.cfg, task.kf_id,
                                            use_stereo=task.use_stereo, draw=task.draw,
                                            kf_count=task.kf_count, timer=self.timer)
                    if task.stream is not None:
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
        dev = ms.kf_pose.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self._tasks.put(MappingTask(ms, int(kf_id), bool(use_stereo), draw, int(kf_count),
                                    stream))
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
