"""Keyframe insertion in the facade (``system.py``): the program's
``keyframe`` stage, mean ms a keyframe, outside the profiled span.  Moves
``frame_ms_p95``."""

LAYER = "facade keyframe insertion"
MOVES = "frame_ms_p95"


def read(run):
    xs = run.stage_durations("keyframe")
    return 1e3 * sum(xs) / len(xs) if xs else None
