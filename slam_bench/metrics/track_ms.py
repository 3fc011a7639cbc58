"""Tracking (``tracking/tracker.py``, ``optim/pose_opt.py``): the program's
``track`` stage less the ``keyframe`` stages it holds, mean ms a tracked
frame, outside the profiled span.  Moves ``frames_per_s``."""

LAYER = "tracking"
MOVES = "frames_per_s"


def read(run):
    xs = run.self_durations("track", "keyframe")
    return 1e3 * sum(xs) / len(xs) if xs else None
